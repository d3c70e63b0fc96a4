"""Input pipeline: static-shape batches and background prefetch (port of
df3d/data/pipeline.py).

Each process builds the batches of its shard of the dataset (the
counterpart of the reference's DistributedSampler), one worker thread
overlaps reading, augmenting and collating with the training step, and
every array is padded to a static shape.

Unlike the JAX package's loader, an exception raised while a batch is
made (by the dataset, the transform or the collate) reaches the consumer,
which re-raises it, rather than leaving the consumer waiting on the queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


def pad_to(arr: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    """Pad or truncate the leading axis to n."""
    if len(arr) >= n:
        return arr[:n]
    pad = np.full((n - len(arr),) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad])


def make_batch(samples: list[dict], max_points: int, max_gt: int,
               num_features: int) -> dict:
    """A padded training batch of dataset samples: points (B, max_points,
    F), points_valid, gt_boxes (B, max_gt, 9), gt_classes, gt_valid, and
    each sample's world augmentation (`aug_params`, identity when absent)
    as noise_rot, noise_scale, flip_x and flip_y (B,)."""
    b = len(samples)
    points = np.zeros((b, max_points, num_features), np.float32)
    points_valid = np.zeros((b, max_points), bool)
    gt_boxes = np.zeros((b, max_gt, 9), np.float32)
    gt_classes = np.zeros((b, max_gt), np.int32)
    gt_valid = np.zeros((b, max_gt), bool)
    aug = {"noise_rot": np.zeros((b,), np.float32),
           "noise_scale": np.ones((b,), np.float32),
           "flip_x": np.zeros((b,), bool),
           "flip_y": np.zeros((b,), bool)}
    for i, s in enumerate(samples):
        p = s["points"][:max_points]
        points[i, : len(p), : p.shape[1]] = p
        points_valid[i, : len(p)] = True
        if "gt_boxes" in s and len(s["gt_boxes"]):
            g = s["gt_boxes"][:max_gt]
            gt_boxes[i, : len(g), : g.shape[1]] = g
            gt_classes[i, : len(g)] = s["gt_classes"][:max_gt]
            gt_valid[i, : len(g)] = True
        if "aug_params" in s:
            ap = s["aug_params"]
            aug["noise_rot"][i] = ap.noise_rot
            aug["noise_scale"][i] = ap.noise_scale
            aug["flip_x"][i] = ap.flip_x
            aug["flip_y"][i] = ap.flip_y
    return {"points": points, "points_valid": points_valid,
            "gt_boxes": gt_boxes, "gt_classes": gt_classes,
            "gt_valid": gt_valid, **aug}


class _Failure:
    """An exception raised in the worker, queued for the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchLoader:
    """Thread-prefetching batch iterator over a map-style dataset.

    One worker thread makes the batches in order (the JAX loader too
    starts one, whatever its `num_workers`, and the transform's draws
    depend on that order). Epoch e shuffles with
    `RandomState(seed + e)`, takes the shard `idx[shard_id::num_shards]`,
    and the transform draws from `RandomState(seed * 7919 + e)`; a dataset
    with `resample` (`CBGSWrapper`) redraws its duplicates with the epoch
    first. `epoch` counts the epochs iterated to their end; a caller that
    resumes a run sets it."""

    def __init__(self, dataset, batch_size: int,
                 collate: Callable[[list], dict], shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2,
                 shard_id: int = 0, num_shards: int = 1,
                 transform: Callable | None = None, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.transform = transform
        self.drop_last = drop_last
        self.epoch = 0

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx[self.shard_id::self.num_shards]

    def __iter__(self) -> Iterator[dict]:
        if hasattr(self.dataset, "resample"):
            self.dataset.resample(self.epoch)
        idx = self._indices()
        nb = (len(idx) // self.batch_size if self.drop_last
              else -(-len(idx) // self.batch_size))
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        closed = threading.Event()

        def put(item) -> bool:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                rng = np.random.RandomState(self.seed * 7919 + self.epoch)
                for b in range(nb):
                    sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    samples = []
                    for i in sel:
                        s = self.dataset[int(i)]
                        if self.transform is not None:
                            s = self.transform(s, rng)
                        samples.append(s)
                    if not put(self.collate(samples)):
                        return
            except BaseException as e:  # re-raised by the consumer below
                put(_Failure(e))
                return
            put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, _Failure):
                    raise item.exc
                yield item
        finally:
            closed.set()
            t.join()
        self.epoch += 1
