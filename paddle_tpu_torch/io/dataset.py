"""Datasets.

Port of paddle_tpu/io/dataset.py: map-style and iterable datasets plus
the combinators Paddle ships (TensorDataset, ComposeDataset,
ChainDataset, Subset, ConcatDataset, random_split). Pure host-side
Python — the transfer to the model's device happens in hapi's train
step, from the batches the DataLoader collates. `random_split` draws its
permutation from numpy (the global RNG, or a RandomState seeded by
`generator`), as the reference's does, so the two packages split alike.
"""
from __future__ import annotations

import bisect

import numpy as np


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lens = {len(t) for t in tensors}
        if len(lens) != 1:
            raise ValueError("all tensors must have the same first dimension")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    """Zip several same-length datasets; sample = flattened fields."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        lens = {len(d) for d in self.datasets}
        if len(lens) != 1:
            raise ValueError("datasets must have equal lengths")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (tuple, list)) else [sample])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds - 1] if ds > 0 else 0
        return self.datasets[ds][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    lengths = list(lengths)
    if all(isinstance(l, float) for l in lengths) and abs(sum(lengths) - 1.0) < 1e-6:
        n = len(dataset)
        sizes = [int(np.floor(n * f)) for f in lengths]
        for i in range(n - sum(sizes)):
            sizes[i % len(sizes)] += 1
        lengths = sizes
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths must equal dataset size")
    if generator is not None:
        # generator: anything with a .seed attribute or an int-like seed,
        # giving a reproducible split (reference random_split generator arg)
        seed = getattr(generator, "seed", generator)
        seed = seed() if callable(seed) else seed
        perm = np.random.RandomState(int(seed)).permutation(len(dataset))
    else:
        perm = np.random.permutation(len(dataset))
    out, ofs = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + l].tolist()))
        ofs += l
    return out
