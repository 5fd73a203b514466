"""Host-side data loading: sharded, shuffled, thread-prefetched batches
(counterpart of `otter_tpu/data/loader.py`).

Replaces torch DataLoader + DistributedProxySampler
(`train_utils.py:102-139`, `instruction_following.py:491-494`) with a
thread-pool prefetch pipeline (PIL/base64 decode release the GIL) feeding
numpy batches; `WeightedMultiLoader` reproduces the size-weighted random
dataloader choice of the train loop (`get_next_dataloader`,
train_utils.py:265-273). The index order, the shards and the loader
choices are the JAX module's.

Two things differ from the JAX module, whose producer thread has no
handler and blocks on a full queue: an exception in the producer (a
sample's `__getitem__`, the collation) reaches the consumer, which
re-raises it, and a consumer that stops early releases the producer.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

_END = object()


class _Failure:
    def __init__(self, error: BaseException):
        self.error = error


class MimicitLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 8, drop_last: bool = True,
                 rank: int = 0, world_size: int = 1,
                 pad_to_multiple: int = 64, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.rank = rank
        self.world_size = world_size
        self.pad_to_multiple = pad_to_multiple
        self.prefetch = prefetch
        self.epoch = 0
        # the producer of the latest iteration (tests join it)
        self.producer: Optional[threading.Thread] = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.dataset.set_epoch(epoch)

    def _indices(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(hash((self.seed, self.epoch))).shuffle(idx)
        # per-process shard (DistributedProxySampler equivalent)
        idx = idx[self.rank::self.world_size]
        if self.drop_last:
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        return idx

    def __len__(self):
        n = len(self.dataset) // self.world_size
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if not batches:
            return
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a full queue holds the producer only until the consumer stops
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__,
                                                batch_idx))
                        if not put(self.dataset.collate(
                                samples,
                                pad_to_multiple=self.pad_to_multiple)):
                            return
            except BaseException as e:    # the consumer re-raises it
                put(_Failure(e))
                return
            put(_END)

        t = threading.Thread(target=produce, daemon=True)
        self.producer = t
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is _END:
                    return
                if isinstance(item, _Failure):
                    raise item.error
                yield item
        finally:
            stop.set()


class WeightedMultiLoader:
    """Size-weighted random choice over task-group loaders, cycling each
    (`train_one_epoch` dataloader selection, instruction_following.py:150
    + train_utils.py:265-273)."""

    def __init__(self, loaders: Sequence[MimicitLoader], seed: int = 0):
        self.loaders = list(loaders)
        self.rng = random.Random(seed)

    def __len__(self):
        return sum(len(l) for l in self.loaders)

    def set_epoch(self, epoch: int):
        for l in self.loaders:
            l.set_epoch(epoch)

    def __iter__(self) -> Iterator[dict]:
        iters = [iter(l) for l in self.loaders]
        weights = [len(l) for l in self.loaders]
        total = sum(weights)
        served = 0
        try:
            while served < total:
                i = self.rng.choices(range(len(iters)), weights=weights)[0]
                try:
                    yield next(iters[i])
                    served += 1
                except StopIteration:
                    iters[i] = iter(self.loaders[i])  # cycle()
        finally:
            for it in iters:        # releases the producers still running
                it.close()
