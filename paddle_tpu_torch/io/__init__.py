"""paddle.io: Dataset / DataLoader / samplers.

Port of paddle_tpu/io: datasets and samplers are host-side Python (the
shuffles draw from numpy's global RNG, as the reference's); the
DataLoader collates batches of CPU `Tensor`s, optionally in pinned
memory, with worker processes handing batches over through a native
shared-memory ring (`csrc/ring_queue.cpp`). The model's consumer (hapi's
train step) moves them to its device.
"""
from .dataset import (
    Dataset,
    IterableDataset,
    TensorDataset,
    ComposeDataset,
    ChainDataset,
    ConcatDataset,
    Subset,
    random_split,
)
from .sampler import (
    Sampler,
    SequenceSampler,
    RandomSampler,
    SubsetRandomSampler,
    WeightedRandomSampler,
    BatchSampler,
    DistributedBatchSampler,
)
from .dataloader import (DataLoader, WorkerInfo, default_collate_fn,
                         get_worker_info)

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split",
    "Sampler", "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "BatchSampler", "DistributedBatchSampler",
    "DataLoader", "WorkerInfo", "default_collate_fn", "get_worker_info",
]
