"""Native (C++) host components, built with g++ at first use.

Port of paddle_tpu/core/native.py for the one component the port uses,
the shared-memory ring of the DataLoader's workers
(`csrc/ring_queue.cpp`, the port's own copy): compiled once into a
shared object under the git-ignored `paddle_tpu_torch/_build/` (named by
the source's hash, written by an atomic rename so concurrent builds
race safely) and bound with ctypes. `load()` returns None when g++ is
missing or the build fails; the DataLoader then takes its queue path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
# build-under-lock is deliberate: it serializes concurrent g++ builds onto
# the atomic-rename cache
_lock = threading.Lock()
_cache: dict[str, object] = {}    # guarded-by: _lock


def _compile(name: str) -> str | None:
    src = os.path.join(_CSRC, f"{name}.cpp")
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    so = os.path.join(_BUILD, f"{name}-{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (subprocess.SubprocessError, OSError):
        return None


def load(name: str):
    """ctypes.CDLL of csrc/<name>.cpp, or None (no toolchain, a failed
    build)."""
    with _lock:
        if name in _cache:
            return _cache[name]
        so = _compile(name)
        lib = None
        if so is not None:
            try:
                lib = ctypes.CDLL(so)
            except OSError:
                lib = None
        _cache[name] = lib
        return lib


def ring_lib():
    lib = load("ring_queue")
    if lib is not None and not getattr(lib, "_typed", False):
        u64, i64, i32 = ctypes.c_uint64, ctypes.c_longlong, ctypes.c_int
        p = ctypes.c_void_p
        lib.ring_header_bytes.restype = u64
        lib.ring_init.argtypes = [p, u64]
        lib.ring_push.argtypes = [p, ctypes.c_char_p, u64]
        lib.ring_push.restype = i32
        lib.ring_next_size.argtypes = [p]
        lib.ring_next_size.restype = i64
        lib.ring_pop.argtypes = [p, ctypes.c_char_p, u64]
        lib.ring_pop.restype = i64
        lib._typed = True
    return lib
