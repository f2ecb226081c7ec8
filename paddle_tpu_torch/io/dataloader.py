"""DataLoader — batches from a Dataset, collated on the host.

Port of paddle_tpu/io/dataloader.py (Paddle's DataLoader with its
multiprocess iterator): the same batching, ordering, worker protocol and
error propagation. Batches are `Tensor`s over CPU torch tensors; the
transfer to the model's device is the consumer's (hapi's train step
copies each batch to the model's device with ``non_blocking=True``).
With ``pin_memory=True`` (and a card present) each batch lands in
page-locked memory, so that copy is asynchronous.

``num_workers > 0`` forks worker processes (``spawn`` where fork is
missing) that index the dataset and collate to numpy; the parent turns
each batch into tensors without a copy (``torch.from_numpy``). The
workers hand batches over through one shared-memory ring each
(``io/shm_channel.py`` over ``csrc/ring_queue.cpp``) when
``use_shared_memory`` and ``FLAGS_dataloader_use_shared_memory`` are on
and the native build is available, else through an ``mp.Queue``; a frame
larger than its ring takes the queue too (the reference's behaviour).
``transport`` counts the frames each path carried in the last worker
epoch. A worker's exception is raised in the consumer. At an epoch's
end the workers get their stop message and a daemon thread joins them,
so the consumer does not wait out their exit.
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import threading

import numpy as np
import torch

from ..core.flags import flag
from ..core.tensor import Tensor
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

_worker_info = None


class WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed=0):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


def _as_array(x):
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def default_collate_fn(batch):
    """list of samples -> batched Tensor(s) on the CPU, mirroring Paddle's
    collate."""
    sample = batch[0]
    if isinstance(sample, (Tensor, torch.Tensor)):
        return Tensor._wrap(torch.stack(
            [s._data if isinstance(s, Tensor) else s for s in batch]))
    if isinstance(sample, np.ndarray):
        return Tensor._wrap(torch.from_numpy(np.stack(batch)))
    if isinstance(sample, (int, np.integer)):
        return Tensor._wrap(torch.from_numpy(np.asarray(batch, np.int64)))
    if isinstance(sample, (float, np.floating)):
        return Tensor._wrap(torch.from_numpy(np.asarray(batch, np.float32)))
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn([s[i] for s in batch])
                for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    raise TypeError(f"cannot collate {type(sample)}")


def _numpy_collate(batch):
    """Worker-side collate: keep numpy (pickles across processes cheaply,
    out of band through the ring)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (list, tuple)):
        return [_numpy_collate([s[i] for s in batch])
                for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: _numpy_collate([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (Tensor, torch.Tensor)):
        return np.stack([_as_array(s) for s in batch])
    return batch


def _to_tensors(obj, pin):
    if isinstance(obj, np.ndarray):
        t = torch.from_numpy(obj)
        return Tensor._wrap(t.pin_memory() if pin else t)
    if isinstance(obj, list):
        return [_to_tensors(o, pin) for o in obj]
    if isinstance(obj, dict):
        return {k: _to_tensors(v, pin) for k, v in obj.items()}
    return obj


def _pin(obj):
    if isinstance(obj, Tensor):
        return Tensor._wrap(obj._data.pin_memory())
    if isinstance(obj, torch.Tensor):
        return obj.pin_memory()
    if isinstance(obj, (list, tuple)):
        out = [_pin(o) for o in obj]
        return out if isinstance(obj, list) else tuple(out)
    if isinstance(obj, dict):
        return {k: _pin(v) for k, v in obj.items()}
    return obj


def get_worker_info():
    return _worker_info


def _worker_loop(dataset, index_queue, data_queue, collate_fn, worker_id,
                 num_workers, worker_init_fn=None, ring_name=None,
                 timeout=120.0):
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset)
    sink = data_queue
    if ring_name is not None:
        try:  # native shared-memory transport (csrc/ring_queue.cpp)
            from .shm_channel import ShmWorkerSender

            sink = ShmWorkerSender(ring_name, data_queue, timeout=timeout)
        except Exception:
            sink = data_queue
    if worker_init_fn is not None:
        try:
            worker_init_fn(worker_id)
        except Exception as e:
            sink.put((-1, None, e))
            return
    while True:
        item = index_queue.get()
        if item is None:
            break
        seq, indices = item
        try:
            samples = [dataset[i] for i in indices]
            sink.put((seq, collate_fn(samples), None))
        except Exception as e:  # surface worker errors on the main process
            sink.put((seq, None, e))
    if sink is not data_queue:
        sink.close()    # drop the ring's exported pointer before exit


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=120, worker_init_fn=None,
                 persistent_workers=False, pin_memory=False):
        self.dataset = dataset
        self.num_workers = max(int(num_workers), 0)
        self.use_shared_memory = use_shared_memory
        self.collate_fn = collate_fn
        self.timeout = timeout or 120
        self.prefetch_factor = max(int(prefetch_factor), 1)
        self.worker_init_fn = worker_init_fn
        # page-locked batches need a card; without one there is nothing
        # to copy asynchronously to
        self.pin_memory = bool(pin_memory) and torch.cuda.is_available()
        #: frames the last worker epoch took over each path
        self.transport = {"ring": 0, "queue": 0}
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("DataLoader over IterableDataset has no len()")
        return len(self.batch_sampler)

    # ------------------------------------------------------------ iteration
    def __iter__(self):
        if self._iterable_mode:
            return self._iter_iterable()
        if self.num_workers == 0:
            return self._iter_sync()
        return self._iter_workers()

    def _collate(self, samples):
        fn = self.collate_fn or default_collate_fn
        out = fn(samples)
        return _pin(out) if self.pin_memory else out

    def _iter_sync(self):
        for indices in self.batch_sampler:
            yield self._collate([self.dataset[i] for i in indices])

    def _iter_iterable(self):
        it = iter(self.dataset)
        while True:
            samples = list(itertools.islice(it, self.batch_size))
            if not samples:
                return
            if len(samples) < self.batch_size and self.drop_last:
                return
            yield self._collate(samples)

    def _iter_workers(self):
        """Round-robin index distribution to worker processes, in-order
        results with a bounded reorder buffer."""
        # fork is cheapest (no re-import, dataset shared copy-on-write);
        # spawn where it is missing. The workers touch no CUDA state.
        method = "fork" if "fork" in mp.get_all_start_methods() else "spawn"
        ctx = mp.get_context(method)
        index_queues = [ctx.Queue() for _ in range(self.num_workers)]
        data_queue = ctx.Queue()
        collate = self.collate_fn or _numpy_collate
        channel = None
        ring_names = [None] * self.num_workers
        if self.use_shared_memory \
                and flag("FLAGS_dataloader_use_shared_memory"):
            try:  # native shm rings; the queue path without them
                from .shm_channel import ShmDataChannel, available

                if available():
                    channel = ShmDataChannel(self.num_workers, data_queue)
                    ring_names = channel.worker_names()
            except Exception:
                channel = None
        source = channel if channel is not None else data_queue
        self.transport = {"ring": 0, "queue": 0}
        workers = [
            ctx.Process(
                target=_worker_loop,
                args=(self.dataset, index_queues[w], data_queue, collate,
                      w, self.num_workers, self.worker_init_fn,
                      ring_names[w], self.timeout),
                daemon=True,
            )
            for w in range(self.num_workers)
        ]
        for w in workers:
            w.start()
        try:
            batches = list(self.batch_sampler)
            inflight = 0
            next_send = 0
            next_yield = 0
            reorder: dict[int, object] = {}
            budget = self.num_workers * self.prefetch_factor
            while next_send < len(batches) and inflight < budget:
                index_queues[next_send % self.num_workers].put(
                    (next_send, batches[next_send]))
                next_send += 1
                inflight += 1
            while next_yield < len(batches):
                while next_yield not in reorder:
                    seq, data, err = source.get(timeout=self.timeout)
                    if channel is None:
                        self.transport["queue"] += 1
                    else:
                        self.transport = {"ring": channel.ring_frames,
                                          "queue": channel.queue_frames}
                    if err is not None:
                        raise err
                    reorder[seq] = data
                    inflight -= 1
                    if next_send < len(batches):
                        index_queues[next_send % self.num_workers].put(
                            (next_send, batches[next_send]))
                        next_send += 1
                        inflight += 1
                data = reorder.pop(next_yield)
                next_yield += 1
                if self.collate_fn is None:
                    data = _to_tensors(data, self.pin_memory)
                elif self.pin_memory:
                    data = _pin(data)
                yield data
        finally:
            for q in index_queues:
                q.put(None)
            if channel is not None:
                channel.close()
            # a forked worker's exit tears down its copy of this process
            # (tens of ms for a trainer's): it is joined off the consumer's
            # path
            threading.Thread(target=_reap, args=(workers,), daemon=True,
                             name="dataloader-reaper").start()


def _reap(workers):
    """Join the epoch's workers (they exit on their stop message);
    terminate one still running after 5 s."""
    for w in workers:
        w.join(timeout=5)
        if w.is_alive():
            w.terminate()
            w.join(timeout=1)
