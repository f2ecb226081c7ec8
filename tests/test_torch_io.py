"""The port's io package held to paddle_tpu's on the CPU.

The cases of tests/test_io.py through both packages, batch for batch:
order, shapes and values with 0 and 2 workers (the port's workers on its
shared-memory ring, `csrc/ring_queue.cpp`, which the test asserts
carried every frame), shuffles drawn from numpy's global RNG alike, the
combinators and `random_split`, the seven samplers, iterable datasets,
custom collate, worker_init_fn, and a worker's exception raised in the
consumer. The port's batches are CPU Tensors (pinned with `pin_memory`
only where a card is present).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import os

import numpy as np
import pytest
import torch

import paddle_tpu.io as rio

import paddle_tpu_torch as pt
import paddle_tpu_torch.io as pio
from paddle_tpu_torch.core.tensor import Tensor


def _square(io):
    class SquareDataset(io.Dataset):
        def __init__(self, n=20):
            self.n = n

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            return np.array([i], "float32"), np.array([i * i], "float32")

    return SquareDataset


def _np(batch):
    if isinstance(batch, (list, tuple)):
        return [_np(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _np(v) for k, v in batch.items()}
    return np.asarray(batch.numpy() if hasattr(batch, "numpy") else batch)


def _epoch(io, seed=None, **kw):
    ds = kw.pop("dataset", None) or _square(io)(kw.pop("n", 20))
    if seed is not None:
        np.random.seed(seed)
    dl = io.DataLoader(ds, **kw)
    return [_np(b) for b in dl], dl


def _same(a, b):
    assert type(a) is type(b) or isinstance(a, np.ndarray)
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and a.shape == b.shape


CASES = {
    "plain": dict(batch_size=4),
    "drop_last": dict(batch_size=4, drop_last=True),
    "shuffle": dict(batch_size=4, shuffle=True, seed=7),
    "shuffle_odd": dict(batch_size=3, shuffle=True, seed=11, n=17),
}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_equal_the_reference(case, workers):
    kw = dict(CASES[case])
    got, dl = _epoch(pio, num_workers=workers, **kw)
    want, _ = _epoch(rio, num_workers=0, **dict(CASES[case]))
    _same(got, want)
    if workers:
        assert dl.transport == {"ring": len(got), "queue": 0}


@pytest.mark.parametrize("workers", [0, 2])
def test_batches_are_cpu_tensors(workers):
    dl = pio.DataLoader(_square(pio)(8), batch_size=4, num_workers=workers,
                        pin_memory=True)
    for x, y in dl:
        assert isinstance(x, Tensor) and x._data.device.type == "cpu"
        assert x._data.is_pinned() == torch.cuda.is_available()


def test_sample_types_collate_alike():
    """ints, floats, dicts, nested tuples and Tensor samples."""
    def make(io, tensor):
        class Mixed(io.Dataset):
            def __len__(self):
                return 6

            def __getitem__(self, i):
                return {"i": i, "f": float(i) / 2,
                        "t": tensor(np.full((2,), i, np.float32)),
                        "n": (np.array([i, -i], np.int32), i + 1)}

        return Mixed()

    import paddle_tpu as paddle

    pt.set_device("cpu")
    got = [_np(b) for b in pio.DataLoader(make(pio, pt.to_tensor),
                                          batch_size=4)]
    want = [_np(b) for b in rio.DataLoader(make(rio, paddle.to_tensor),
                                           batch_size=4)]
    _same(got, want)


def test_custom_collate():
    for io in (rio, pio):
        dl = io.DataLoader(_square(io)(4), batch_size=2,
                           collate_fn=lambda items: sum(int(x[0])
                                                        for x, _ in items))
        assert list(dl) == [1, 5]


@pytest.mark.parametrize("workers", [0, 2])
def test_tensor_dataset(workers):
    pt.set_device("cpu")
    a = pt.to_tensor(np.arange(6, dtype="float32").reshape(6, 1))
    b = pt.to_tensor(np.arange(6, dtype="int64"))
    ds = pio.TensorDataset([a, b])
    assert len(ds) == 6
    x, y = ds[2]
    assert float(x.numpy()[0]) == 2.0 and int(y.numpy()) == 2
    got = [_np(bt) for bt in pio.DataLoader(ds, batch_size=4,
                                            num_workers=workers)]
    assert [g[0].ravel().tolist() for g in got] == [[0, 1, 2, 3], [4, 5]]


def test_worker_init_fn_called(tmp_path):
    marker = str(tmp_path / "w{}.txt")

    def init_fn(worker_id):
        open(marker.format(worker_id), "w").write("hi")

    list(pio.DataLoader(_square(pio)(8), batch_size=2, num_workers=2,
                        worker_init_fn=init_fn))
    assert os.path.exists(marker.format(0))
    assert os.path.exists(marker.format(1))


def test_multiple_epochs_reuse():
    dl = pio.DataLoader(_square(pio)(8), batch_size=4, num_workers=2)
    for _ in range(3):
        assert len(list(dl)) == 2


@pytest.mark.parametrize("ring", [True, False])
def test_worker_exception_propagates(ring):
    class Bad(pio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise ValueError("boom at 2")
            return np.zeros(1, "float32")

    dl = pio.DataLoader(Bad(), batch_size=1, num_workers=2,
                        use_shared_memory=ring)
    with pytest.raises(ValueError, match="boom"):
        list(dl)


def test_queue_path_without_shared_memory():
    from paddle_tpu_torch.core.flags import flag, set_flags

    old = flag("FLAGS_dataloader_use_shared_memory")
    set_flags({"FLAGS_dataloader_use_shared_memory": False})
    try:
        got, dl = _epoch(pio, num_workers=2, batch_size=4)
    finally:
        set_flags({"FLAGS_dataloader_use_shared_memory": old})
    want, _ = _epoch(rio, batch_size=4)
    _same(got, want)
    assert dl.transport == {"ring": 0, "queue": len(got)}


def test_oversize_frames_take_the_queue():
    """A frame larger than its ring goes through the mp.Queue (the
    reference's fallback), in order."""
    from paddle_tpu_torch.io import shm_channel

    class Big(pio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return np.full((300,), i, np.float32)

    orig = shm_channel.ShmDataChannel.__init__

    def small(self, n, q, ring_bytes=64 << 20):
        orig(self, n, q, ring_bytes=1024)

    shm_channel.ShmDataChannel.__init__ = small
    try:
        dl = pio.DataLoader(Big(), batch_size=1, num_workers=2)
        got = [b.numpy()[0, 0] for b in dl]
    finally:
        shm_channel.ShmDataChannel.__init__ = orig
    assert got == [0, 1, 2, 3] and dl.transport["queue"] == 4


# -------------------------------------------------------------- samplers
def test_samplers_equal_the_reference():
    out = {}
    for name, io in (("ref", rio), ("port", pio)):
        ds = _square(io)(10)
        np.random.seed(5)
        out[name] = (
            list(io.SequenceSampler(ds)),
            list(io.RandomSampler(ds)),
            list(io.RandomSampler(ds, replacement=True, num_samples=7)),
            list(io.WeightedRandomSampler(np.arange(1, 11), 6)),
            list(io.BatchSampler(dataset=ds, batch_size=3)),
            list(io.BatchSampler(dataset=ds, batch_size=3, drop_last=True)),
            list(io.BatchSampler(dataset=ds, shuffle=True, batch_size=4)),
            list(io.DistributedBatchSampler(ds, 3, num_replicas=2, rank=1,
                                            shuffle=True)),
            len(io.DistributedBatchSampler(ds, 3, num_replicas=2, rank=0)))
    assert out["port"] == out["ref"]


def test_subset_random_sampler_and_default_distributed():
    s = pio.SubsetRandomSampler([3, 5, 7, 9])
    assert sorted(s) == [3, 5, 7, 9] and len(s) == 4
    ds = _square(pio)(10)
    d = pio.DistributedBatchSampler(ds, 4)
    assert list(d) == list(pio.BatchSampler(dataset=ds, batch_size=4))


def test_dataloader_with_batch_sampler():
    bs = pio.BatchSampler(dataset=_square(pio)(8), batch_size=4)
    assert len(list(pio.DataLoader(_square(pio)(8), batch_sampler=bs))) == 2


# -------------------------------------------------------------- datasets
def test_combinators_equal_the_reference():
    out = {}
    for name, io in (("ref", rio), ("port", pio)):
        a, b = _square(io)(5), _square(io)(3)
        cat = io.ConcatDataset([a, b])
        comp = io.ComposeDataset([a, _square(io)(5)])
        sub = io.Subset(a, [4, 0, 2])
        np.random.seed(2)
        parts = io.random_split(_square(io)(10), [0.5, 0.3, 0.2])
        seeded = io.random_split(_square(io)(6), [4, 2], generator=3)
        out[name] = ([_np(list(cat[i])) for i in (-1, 0, 5, 7)], len(cat),
                     [_np(list(comp[i])) for i in range(2)],
                     [_np(list(sub[i])) for i in range(3)],
                     [p.indices for p in parts],
                     [p.indices for p in seeded])
    assert str(out["port"]) == str(out["ref"])


def test_iterable_and_chain_datasets():
    for io in (rio, pio):
        class Stream(io.IterableDataset):
            def __iter__(self):
                for i in range(7):
                    yield np.array([i], "float32")

        batches = list(io.DataLoader(Stream(), batch_size=3))
        assert [b.shape[0] for b in batches] == [3, 3, 1]
        chained = list(iter(io.ChainDataset([Stream(), Stream()])))
        assert len(chained) == 14
        with pytest.raises(TypeError):
            len(io.DataLoader(Stream(), batch_size=3))


def test_public_names_are_the_reference():
    assert sorted(pio.__all__) == sorted(rio.__all__)
