"""Shared-memory batch transport for the DataLoader worker path.

Port of paddle_tpu/io/shm_channel.py (the role of Paddle's shared-memory
queue under its multiprocess DataLoader iterator). Each worker owns one
native SPSC ring (csrc/ring_queue.cpp, built by core/native.py) inside a
multiprocessing.SharedMemory segment; numpy payloads travel as
pickle-protocol-5 out-of-band buffers, so array bytes are ONE memcpy into
the ring and one out — no pipe writes, no per-array pickle copies.
Frames that can't fit fall back to the mp.Queue path; the channel counts
the frames each path carried (`ring_frames`, `queue_frames`).
"""
from __future__ import annotations

import ctypes
import pickle
import struct
import time
from multiprocessing import shared_memory

from ..core import native


def available() -> bool:
    return native.ring_lib() is not None


def _encode(obj) -> bytes:
    buffers: list = []
    head = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    parts = [struct.pack("<II", len(head), len(buffers)), head]
    for b in buffers:
        raw = b.raw()
        parts.append(struct.pack("<Q", raw.nbytes))
        parts.append(raw)
    return b"".join(parts)


def _decode(frame: memoryview):
    n_head, n_buf = struct.unpack_from("<II", frame, 0)
    off = 8
    head = bytes(frame[off:off + n_head])
    off += n_head
    bufs = []
    for _ in range(n_buf):
        (n,) = struct.unpack_from("<Q", frame, off)
        off += 8
        # bytearray: reconstructed arrays stay WRITABLE, matching the
        # mp.Queue fallback path (bytes would make them read-only)
        bufs.append(bytearray(frame[off:off + n]))
        off += n
    return pickle.loads(head, buffers=bufs)


class ShmRing:
    """One SPSC ring in a SharedMemory segment (producer=worker)."""

    def __init__(self, size: int = 64 << 20, name: str | None = None,
                 create: bool = True):
        self._lib = native.ring_lib()
        if self._lib is None:
            raise RuntimeError("native ring_queue unavailable")
        self.shm = shared_memory.SharedMemory(create=create, size=size,
                                              name=name)
        self._cbuf = (ctypes.c_char * self.shm.size).from_buffer(self.shm.buf)
        self._ptr = ctypes.addressof(self._cbuf)
        if create:
            self._lib.ring_init(self._ptr, self.shm.size)
        self.capacity = self.shm.size - int(self._lib.ring_header_bytes())

    @property
    def name(self):
        return self.shm.name

    def push(self, payload: bytes, timeout: float = 120.0) -> bool:
        """Blocking push; False only when the frame can NEVER fit."""
        deadline = time.monotonic() + timeout
        while True:
            rc = self._lib.ring_push(self._ptr, payload, len(payload))
            if rc == 0:
                return True
            if rc == -2:
                return False  # oversize: caller uses the fallback queue
            if time.monotonic() > deadline:
                raise TimeoutError("shm ring full for too long")
            time.sleep(0.0005)

    def try_pop(self):
        """One frame as a decoded object, or None when empty."""
        size = self._lib.ring_next_size(self._ptr)
        if size < 0:
            return None
        buf = ctypes.create_string_buffer(int(size))
        got = self._lib.ring_pop(self._ptr, buf, int(size))
        if got < 0:
            return None
        return _decode(memoryview(buf)[:int(got)])

    def close(self, unlink: bool = False):
        # the exported pointer must be dropped before the mmap can close
        del self._cbuf
        self._ptr = None
        try:
            self.shm.close()
            if unlink:
                self.shm.unlink()
        except (FileNotFoundError, OSError):
            pass


class ShmDataChannel:
    """Parent-side multiplexer over per-worker rings + an mp.Queue fallback
    for oversize frames; same (seq, data, err) contract as the queue path."""

    def __init__(self, num_workers: int, fallback_queue,
                 ring_bytes: int = 64 << 20):
        self.rings = [ShmRing(ring_bytes) for _ in range(num_workers)]
        self.fallback = fallback_queue
        self.ring_frames = 0
        self.queue_frames = 0

    def worker_names(self):
        return [r.name for r in self.rings]

    def get(self, timeout: float = 120.0):
        deadline = time.monotonic() + timeout
        delay = 0.0005
        while True:
            for ring in self.rings:
                item = ring.try_pop()
                if item is not None:
                    self.ring_frames += 1
                    return item
            try:
                item = self.fallback.get_nowait()
            except Exception:
                pass
            else:
                self.queue_frames += 1
                return item
            if time.monotonic() > deadline:
                raise TimeoutError("no batch from workers within timeout")
            time.sleep(delay)
            # back off toward 20ms when idle so a slow dataset doesn't cost
            # the fork-shared workers a busy-polling core
            delay = min(delay * 1.5, 0.02)

    def close(self):
        for r in self.rings:
            r.close(unlink=True)


class ShmWorkerSender:
    """Worker-side producer handle (attaches to the parent's segment)."""

    def __init__(self, ring_name: str, fallback_queue, timeout: float = 120.0):
        self.ring = ShmRing(name=ring_name, create=False, size=1)  # attach
        self.fallback = fallback_queue
        self.timeout = timeout

    def put(self, item):
        payload = _encode(item)
        try:
            fits = self.ring.push(payload, timeout=self.timeout)
        except TimeoutError:
            fits = False  # ring wedged: the mp.Queue still reaches the parent
        if not fits:
            self.fallback.put(item)  # oversize frame or stuck ring

    def close(self):
        self.ring.close()
