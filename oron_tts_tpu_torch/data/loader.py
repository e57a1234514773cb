"""Threaded prefetching data loader.

Counterpart of the JAX package's ``data/loader.py``: decoding and mel
extraction run in a thread pool while the device works on the previous
batch; a sample that fails to load is skipped with a warning.
"""

from __future__ import annotations

import logging
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator

_logger = logging.getLogger(__name__)


class DataLoader:
    def __init__(
        self,
        dataset: Any,
        batch_sampler: Iterable[list[int]],
        collate_fn: Callable[[list[dict]], dict],
        num_workers: int = 2,
        prefetch: int = 2,
    ) -> None:
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn
        self.num_workers = max(0, num_workers)
        self.prefetch = max(1, prefetch)

    def __len__(self) -> int:
        return len(self.batch_sampler)  # type: ignore[arg-type]

    def _build(self, indices: list[int]) -> dict | None:
        items = []
        for i in indices:
            try:
                items.append(self.dataset[i])
            except Exception as exc:  # one bad sample must not stop an epoch
                _logger.warning("Skipping sample %d: %s", i, exc)
        return self.collate_fn(items) if items else None

    def __iter__(self) -> Iterator[dict]:
        if self.num_workers == 0:
            for indices in self.batch_sampler:
                batch = self._build(list(indices))
                if batch is not None:
                    yield batch
            return
        # submit lazily: at most num_workers + prefetch batches in flight
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: deque = deque()
            it = iter(self.batch_sampler)
            exhausted = False
            while True:
                while not exhausted and len(pending) < self.num_workers + self.prefetch:
                    try:
                        indices = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    pending.append(pool.submit(self._build, list(indices)))
                if not pending:
                    break
                batch = pending.popleft().result()
                if batch is not None:
                    yield batch
