"""Host-side batch loader (the port's copy of ``gstx/data/loader.py``).

Map-style datasets (``__getitem__``/``__len__`` of numpy dicts) are batched
into fixed-shape numpy arrays and prefetched with a thread pool while the
previous step runs on device.  Determinism: each item gets a per-(epoch,
index) seed derived from the loader seed, so runs reproduce regardless of
worker scheduling (the reference's DataLoader workers are nondeterministic).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from gstx_torch.core import profiling


def collate(items) -> Dict[str, np.ndarray]:
    """Stack a list of item dicts into one batch dict."""
    keys = items[0].keys()
    return {k: np.stack([it[k] for it in items]) for k in keys}


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8,
                 seed: int = 0, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 even_stripes: bool = False):
        """``process_index/process_count``: multi-host striping — each host
        iterates only its slice of the (identically shuffled) global order,
        so per-host batches concatenate into a consistent global batch.

        ``even_stripes``: truncate the global order to a process_count
        multiple BEFORE striping so every host sees the SAME number of
        items (and therefore batches) per epoch.  Required whenever the
        per-host batches assemble collectively (training via
        a collective batch assembly): ragged stripes would let some
        hosts roll into the next epoch while others still feed the
        collective, desynchronizing iter_id and the checkpoint barriers.
        Drops < process_count items per epoch (different ones each epoch
        under shuffle).  Leave False for independent per-host work
        (generation/eval shards), where every item must be covered."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = max(1, process_count)
        self.even_stripes = even_stripes
        # detect seed support ONCE by signature: a try/except TypeError in
        # _get would silently mask TypeErrors raised inside dataset code
        import inspect

        try:
            sig = inspect.signature(dataset.__getitem__)
            self._seeded = "seed" in sig.parameters
        except (TypeError, ValueError):
            self._seeded = False

    def _stripe_len(self) -> int:
        n = len(self.dataset)
        if self.even_stripes:
            return n // self.process_count
        # len(range(process_index, n, process_count))
        return max(0, (n - self.process_index + self.process_count - 1)
                   // self.process_count)

    def _order(self, epoch_id: int) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            # same seed on every host -> identical global order
            np.random.RandomState(self.seed + epoch_id).shuffle(order)
        if self.even_stripes:
            order = order[: n - n % self.process_count]
        return order[self.process_index::self.process_count]

    def __len__(self) -> int:
        n = self._stripe_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch_id: int = 0,
              start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """``start_batch``: resume mid-epoch without paying the host cost of
        the skipped batches (items get per-(epoch, index) seeds, so batch
        ``i`` is identical whether or not 0..i-1 were fetched)."""
        order = self._order(epoch_id)
        n = len(order)
        nb = len(self)

        def fetch(i):
            # a task: a worker's batch may begin before a traced window
            with profiling.task("gstx:loader.fetch"):
                lo = i * self.batch_size
                hi = min(lo + self.batch_size, n)
                idx = order[lo:hi]
                items = [self._get(int(j), epoch_id) for j in idx]
                batch = collate(items)
            profiling.count("loader.batches")
            return batch

        if self.num_workers <= 1:
            for i in range(start_batch, nb):
                yield fetch(i)
            return

        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = []
            depth = max(1, self.prefetch)
            for i in range(start_batch, min(start_batch + depth, nb)):
                pending.append(pool.submit(fetch, i))
            nxt = start_batch + len(pending)
            for i in range(start_batch, nb):
                with profiling.span("gstx:loader.wait"):
                    batch = pending.pop(0).result()
                if nxt < nb:
                    pending.append(pool.submit(fetch, nxt))
                    nxt += 1
                yield batch

    def _get(self, index: int, epoch_id: int):
        if not self._seeded:
            return self.dataset[index]
        seed = (self.seed * 1_000_003 + epoch_id * 97 + index) % (2**31 - 1)
        return self.dataset.__getitem__(index, seed=seed)



def batch_iter(loader: DataLoader, num_epochs: int, start_epoch: int = 0,
               start_idx: int = 0):
    """(epoch_id, idx, batch) over the epochs (``gstx/data/loader.py:
    129-141``, reference utils/data_utils.py:20-23).  ``start_idx``: the
    batch offset within ``start_epoch`` (a mid-epoch resume); later epochs
    start at 0.  ``idx`` is the batch's index within its epoch, and the
    skipped batches are never fetched (the per-(epoch, index) item seeds
    make batch i the same either way)."""
    for epoch_id in range(start_epoch, num_epochs):
        first = start_idx if epoch_id == start_epoch else 0
        for off, batch in enumerate(loader.epoch(epoch_id,
                                                 start_batch=first)):
            yield epoch_id, first + off, batch
