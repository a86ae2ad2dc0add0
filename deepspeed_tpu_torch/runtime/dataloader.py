"""Data loading.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py``: a shuffling,
epoch-aware batch loader over a map-style dataset (shuffled with a numpy
``RandomState(seed + epoch)``, so both packages visit the samples in the
same order) and ``RepeatingLoader``. The port trains in one process, so the
loader always yields the whole batch; the engine moves it to the device.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np


def default_collate(samples: Sequence[Any]) -> Any:
    """Stack a list of samples (dicts / tuples / arrays) into one batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples])
                           for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    """Shuffling, epoch-aware batch loader over a map-style dataset."""

    def __init__(self, dataset: Any, batch_size: int,
                 collate_fn: Optional[Callable] = None, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 num_local_io_workers: int = 0, data_sampler=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.data_sampler = data_sampler
        self.len = (len(dataset) // batch_size if drop_last
                    else (len(dataset) + batch_size - 1) // batch_size)

    def __len__(self) -> int:
        return self.len

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        if self.data_sampler is not None:
            return np.asarray(list(self.data_sampler))
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[Any]:
        idx = self._indices()
        for b in range(self.len):
            batch_idx = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if len(batch_idx) < self.batch_size and self.drop_last:
                break
            yield self.collate_fn([self.dataset[int(i)] for i in batch_idx])
        self.epoch += 1


class RepeatingLoader:
    """Wraps an iterable and restarts it on ``StopIteration``."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)
