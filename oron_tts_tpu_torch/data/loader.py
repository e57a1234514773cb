"""Threaded prefetching data loader.

Counterpart of the JAX package's ``data/loader.py``: decoding and mel
extraction run in a thread pool while the device works on the previous
batch; a sample that fails to load is skipped with a warning. A sampler
entry is a list of indices, or ``(indices, collate_kwargs)`` from
``GlobalBatchSchedule``, whose kwargs (the globally agreed pad targets) go
to the collator; with a scheduled shape even an all-failed batch is
emitted, as pure padding, since the other ranks expect the step.
"""

from __future__ import annotations

import logging
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator

from oron_tts_tpu_torch.utils import trace

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

    @staticmethod
    def _split_entry(entry) -> tuple[list[int], dict]:
        if isinstance(entry, tuple) and len(entry) == 2 and isinstance(entry[1], dict):
            return list(entry[0]), entry[1]
        return list(entry), {}

    def _build(self, indices: list[int], collate_kwargs: dict) -> dict | None:
        items = []
        for i in indices:
            try:
                items.append(self.dataset[i])
            except Exception as exc:  # one bad sample must not stop an epoch
                _logger.warning("Skipping sample %d: %s", i, exc)
        if not items and not collate_kwargs.get("pad_t_to"):
            return None
        return self.collate_fn(items, **collate_kwargs)

    def __iter__(self) -> Iterator[dict]:
        if self.num_workers == 0:
            for entry in self.batch_sampler:
                with trace.span("loader.wait"):
                    batch = self._build(*self._split_entry(entry))
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
                        entry = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    pending.append(pool.submit(self._build, *self._split_entry(entry)))
                if not pending:
                    break
                with trace.span("loader.wait"):
                    batch = pending.popleft().result()
                if batch is not None:
                    yield batch
