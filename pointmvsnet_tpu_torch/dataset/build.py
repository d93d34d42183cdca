"""Batch loader: collation, shuffling, background prefetch. The port's copy
of ``pointmvsnet_tpu/dataset/build.py`` (numpy batches; the train and eval
steps move them to the device): the train and val splits of the DTU
training release, and the test split of DTU or Tanks & Temples
(``DATA.TEST.DATASET``).

Under data parallelism (``parallel/distributed.py``) the train and val
batch sizes are the global batch, as in the JAX package where
``shard_batch`` splits it: every rank draws the same shuffled batches
(seeded by ``seed + epoch``) and keeps rows ``[r·b/W, (r+1)·b/W)`` of
each, so W ranks together see the one-rank run's batches. The test split
instead gives each rank every W-th item (``RankShard``): each exports its
own maps, and no item is exported twice.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np


def collate(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts into a batch dict (adds leading B dim)."""
    keys = items[0].keys()
    return {k: np.stack([np.asarray(it[k]) for it in items]) for k in keys}


PREFETCH = 2       # batches decoded ahead by the worker thread


class DataLoader:
    """Minimal epoch-based loader. With ``drop_last`` the last partial
    batch is dropped, so every batch has the same shape (training);
    without it the last batch is shorter (the test split exports every
    view). ``num_workers`` > 0 decodes batches in one background thread,
    ``PREFETCH`` batches ahead. ``rank`` of ``world``: each batch of
    ``batch_size`` rows is the global one, of which this loader yields
    rows ``[rank·b/world, (rank+1)·b/world)``."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 0, drop_last: bool = True,
                 rank: int = 0, world: int = 1):
        if batch_size % world or not drop_last and world > 1:
            raise ValueError(f"a batch of {batch_size} cannot be split over {world} "
                             f"ranks (the batch size must be a multiple of the world "
                             f"size, and every batch full)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _batch_indices(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        nb = len(self)
        per = self.batch_size // self.world
        lo = [i * self.batch_size + self.rank * per for i in range(nb)]
        return [idx[i:i + per] for i in lo]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batch_indices()
        if self.num_workers <= 0:
            for b in batches:
                yield collate([self.dataset[int(i)] for i in b])
            return
        yield from self._threaded_iter(batches)

    def _threaded_iter(self, batches):
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def worker():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(collate([self.dataset[int(i)] for i in b]))
            except Exception as e:  # surface loader errors in the main thread
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # a consumer that stops early leaves the worker blocked on a full
            # queue: drain it so the thread ends and frees its batches
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.05)


class RankShard:
    """Items ``rank``, ``rank + world``, ... of ``dataset``."""

    def __init__(self, dataset, rank: int, world: int):
        self.dataset, self.rank, self.world = dataset, rank, world

    def __len__(self) -> int:
        return len(range(self.rank, len(self.dataset), self.world))

    def __getitem__(self, i: int):
        return self.dataset[self.rank + i * self.world]


def build_data_loader(cfg, mode: str = "train", shard=None, base: int = 64) -> DataLoader:
    """cfg → this rank's loader of the "train", "val" or "test" split
    (the whole split without a process group). ``shard`` (test split):
    (index, count) of this rank's share of the items, default (rank,
    world size); on an eval grid (data index, data size). ``base`` (test
    split): the views are cropped to multiples of it (the model's
    ``crop_base``)."""
    from pointmvsnet_tpu_torch.dataset.dtu import DTUTestDataset, DTUTrainValDataset
    from pointmvsnet_tpu_torch.parallel import distributed

    if mode not in ("train", "val", "test"):
        raise ValueError(f"mode {mode!r}: want 'train', 'val' or 'test'")
    if mode == "test":
        t = cfg.DATA.TEST
        kw = dict(num_view=t.NUM_VIEW, num_virtual_plane=t.NUM_VIRTUAL_PLANE,
                  interval_scale=t.INTERVAL_SCALE, img_height=t.IMG_HEIGHT,
                  img_width=t.IMG_WIDTH, base=base)
        if t.DATASET == "tanks":
            from pointmvsnet_tpu_torch.dataset.tanks import TanksDataset
            ds = TanksDataset(t.ROOT_DIR, rescale_depth=t.RESCALE_DEPTH,
                              shape_set=tuple(t.SHAPE_SET) or None, **kw)
        elif t.DATASET == "dtu":
            ds = DTUTestDataset(t.ROOT_DIR, **kw)
        else:
            raise ValueError(f"DATA.TEST.DATASET={t.DATASET!r}: want 'dtu' or 'tanks'")
        index, count = shard or (distributed.rank(), distributed.world_size())
        if count > 1:
            ds = RankShard(ds, index, count)
        return DataLoader(ds, cfg.TEST.BATCH_SIZE, shuffle=False, drop_last=False,
                          num_workers=cfg.DATA.NUM_WORKERS)
    split = cfg.DATA.TRAIN if mode == "train" else cfg.DATA.VAL
    ds = DTUTrainValDataset(
        split.ROOT_DIR, mode=mode,
        num_view=split.NUM_VIEW,
        num_virtual_plane=cfg.DATA.TRAIN.NUM_VIRTUAL_PLANE,
        interval_scale=cfg.DATA.TRAIN.INTERVAL_SCALE)
    return DataLoader(ds, cfg.TRAIN.BATCH_SIZE, shuffle=mode == "train",
                      seed=cfg.RNG_SEED, num_workers=cfg.DATA.NUM_WORKERS,
                      rank=distributed.rank(), world=distributed.world_size())
