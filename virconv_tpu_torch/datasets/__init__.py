"""Dataset registry and the loader.

The port's copy of ``virconv_tpu/datasets/__init__.py``: a string
registry; in training an epoch shuffle from ``np.random.default_rng(
shuffle_seed + epoch)`` (``set_epoch``) and no last partial batch; at
evaluation pad + stride sharding of the frames over ``num_shards``
processes; and one producer thread that loads and collates batches ahead
of the consumer (``DataLoader.PREFETCH`` batches). The producer draws
every random number of the samples, in order, from the dataset's
``RandomState``, a replacement index for a ``None`` sample included; with
``frame_streams`` it reseeds that state before each frame from (seed,
frame index), so that a frame's draws do not depend on which frames a
process loaded before it (distributed evaluation).

Training over ``num_shards`` data-parallel ranks keeps the shuffle seed
shared, drops the frames past the last whole global batch (``batch_size``
x ``num_shards`` frames) and gives rank r the r-th block of
``batch_size`` consecutive frames of each global batch: the ranks' batch k
together are the one-process global batch k, in rank order.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from .dataset import DatasetTemplate
from .kitti.kitti_dataset import KittiDataset
from .kitti.kitti_dataset_mm import KittiDatasetMM
from .kitti.kitti_dataset_semi import KittiDatasetSemi

__all__ = {
    'DatasetTemplate': DatasetTemplate,
    'KittiDataset': KittiDataset,
    'KittiDatasetMM': KittiDatasetMM,
    'KittiDatasetSemi': KittiDatasetSemi,
}


PRODUCER = 'virconv-loader-producer'


class DataLoader:
    """Batches of ``dataset.collate_batch``, in index order or (``shuffle``)
    in the epoch's permutation.

    ``host_seconds`` and ``frames`` add up the producer's time to load and
    collate and the frames it loaded."""

    PREFETCH = 2              # batches the producer may run ahead

    def __init__(self, dataset, batch_size, num_shards=1, shard_id=0,
                 shuffle=False, seed=0, drop_last=False, frame_streams=None):
        """``frame_streams``: None, or the seed of the per-frame streams."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.frame_streams = frame_streams
        self.epoch = 0
        self.host_seconds = 0.0
        self.frames = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        if self.num_shards > 1 and self.drop_last:
            # training: the shard's block of every whole global batch
            per = self.batch_size * self.num_shards
            idx = idx[:len(idx) // per * per].reshape(
                -1, self.num_shards, self.batch_size)[:, self.shard_id]
            idx = idx.reshape(-1)
        elif self.num_shards > 1:
            # pad + stride sharding (the reference's eval sampler)
            pad = (-len(idx)) % self.num_shards
            idx = np.concatenate([idx, idx[:pad]])[self.shard_id::
                                                   self.num_shards]
        return idx

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _sample(self, i):
        if self.frame_streams is not None:
            self.dataset.rng.seed(int(np.random.SeedSequence(
                [self.frame_streams, int(i)]).generate_state(1)[0]))
        s = self.dataset[int(i)]
        while s is None:
            s = self.dataset[int(self.dataset.rng.randint(
                len(self.dataset)))]
        return s

    def __iter__(self):
        idx = self._indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        q = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                for bidx in batches:
                    t0 = time.perf_counter()
                    batch = self.dataset.collate_batch(
                        [self._sample(i) for i in bidx])
                    self.host_seconds += time.perf_counter() - t0
                    self.frames += len(bidx)
                    if not put(('batch', batch)):
                        return
            except BaseException as e:        # handed to the consumer
                put(('error', e))
            else:
                put(('done', None))

        thread = threading.Thread(target=produce, name=PRODUCER, daemon=True)
        thread.start()
        try:
            while True:
                kind, item = q.get()
                if kind == 'error':
                    raise item
                if kind == 'done':
                    return
                yield item
        finally:
            stop.set()
            thread.join()


def build_dataloader(dataset_cfg, class_names, batch_size, root_path=None,
                     logger=None, seed=0, num_shards=1, shard_id=0,
                     training=False, shuffle_seed=None, frame_streams=False):
    """(dataset, loader) of ``dataset_cfg.DATASET``; ``seed`` seeds the
    dataset's ``RandomState`` (with ``frame_streams``, each frame's from
    (seed, frame index)). ``training``: the training split and
    augmentations, shuffled epochs (from ``shuffle_seed``, by default
    ``seed``) and no last partial batch; ``batch_size`` is the frames of
    one shard."""
    if dataset_cfg.DATASET not in __all__:
        raise NotImplementedError(
            f'dataset {dataset_cfg.DATASET!r} is not ported (registered: '
            f'{sorted(__all__)})')
    dataset = __all__[dataset_cfg.DATASET](
        dataset_cfg=dataset_cfg, class_names=class_names,
        root_path=root_path, logger=logger, seed=seed, training=training)
    loader = DataLoader(dataset, batch_size, num_shards=num_shards,
                        shard_id=shard_id, shuffle=training,
                        seed=seed if shuffle_seed is None else shuffle_seed,
                        drop_last=training,
                        frame_streams=seed if frame_streams else None)
    return dataset, loader
