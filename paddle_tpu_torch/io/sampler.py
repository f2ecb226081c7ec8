"""Samplers.

Port of paddle_tpu/io/sampler.py. RandomSampler and
WeightedRandomSampler draw from numpy's global RNG, as the reference's
do: shuffled orders are equal across the two packages, and a resumed
run replays an epoch's order from the numpy state saved at its start
(ckpt/data.py). DistributedBatchSampler keeps the reference's
rank/num_replicas contract (a per-rank slice of the epoch); without the
distributed entry (ROADMAP 'After these', Distributed) rank defaults to
0 of 1 replica and it degrades to a plain BatchSampler.
SubsetRandomSampler draws from the Tensor API's generator
(`core.rng`), as the reference's draws from its framework key; the two
orders differ (the streams differ by design).
"""
from __future__ import annotations

import math

import numpy as np


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples if self._num_samples is not None else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            yield from np.random.randint(0, n, self.num_samples).tolist()
        else:
            yield from np.random.permutation(n)[: self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(
            len(self.weights), self.num_samples, replace=self.replacement, p=p)
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.shuffle = shuffle

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)


class DistributedBatchSampler(BatchSampler):
    """Paddle's DistributedBatchSampler: the rank's slice of each
    epoch."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None:
            num_replicas = 1
        if rank is None:
            rank = 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate([indices, indices[: self.total_size - n]])
        local = indices[self.local_rank::self.nranks].tolist()
        batch = []
        for idx in local:
            batch.append(int(idx))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return math.ceil(self.num_samples / self.batch_size)




class SubsetRandomSampler(Sampler):
    """Random order over a fixed index subset."""

    def __init__(self, indices):
        if len(indices) == 0:
            raise ValueError("indices must not be empty")
        self.indices = list(indices)

    def __iter__(self):
        import torch

        from ..core import rng

        order = torch.randperm(len(self.indices),
                               generator=rng.generator("cpu")).tolist()
        return iter(self.indices[i] for i in order)

    def __len__(self):
        return len(self.indices)
