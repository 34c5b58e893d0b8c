"""Dataset registry and the evaluation loader.

The port's copy of ``virconv_tpu/datasets/__init__.py`` at evaluation: a
string registry, pad + stride sharding of the frames over ``num_shards``
processes, and one producer thread that loads and collates batches ahead
of the consumer (``DataLoader.PREFETCH`` batches). The producer draws
every random number of the samples, in order, from the dataset's
``RandomState``.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from .dataset import DatasetTemplate
from .kitti.kitti_dataset_mm import KittiDatasetMM

__all__ = {
    'DatasetTemplate': DatasetTemplate,
    'KittiDatasetMM': KittiDatasetMM,
}


PRODUCER = 'virconv-loader-producer'


class DataLoader:
    """Batches of ``dataset.collate_batch`` in index order.

    ``host_seconds`` and ``frames`` add up the producer's time to load and
    collate and the frames it loaded."""

    PREFETCH = 2              # batches the producer may run ahead

    def __init__(self, dataset, batch_size, num_shards=1, shard_id=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.host_seconds = 0.0
        self.frames = 0

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.num_shards > 1:
            # pad + stride sharding (the reference's eval sampler)
            pad = (-len(idx)) % self.num_shards
            idx = np.concatenate([idx, idx[:pad]])[self.shard_id::
                                                   self.num_shards]
        return idx

    def __len__(self):
        return -(-len(self._indices()) // self.batch_size)

    def __iter__(self):
        idx = self._indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
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
                        [self.dataset[int(i)] for i in bidx])
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
                     logger=None, seed=0, num_shards=1, shard_id=0):
    """(dataset, loader) of ``dataset_cfg.DATASET``; ``seed`` seeds the
    dataset's ``RandomState``."""
    if dataset_cfg.DATASET not in __all__:
        raise NotImplementedError(
            f'dataset {dataset_cfg.DATASET!r} is not ported (registered: '
            f'{sorted(__all__)}); KittiDatasetSemi comes with VirConv-S')
    dataset = __all__[dataset_cfg.DATASET](
        dataset_cfg=dataset_cfg, class_names=class_names,
        root_path=root_path, logger=logger, seed=seed)
    loader = DataLoader(dataset, batch_size, num_shards=num_shards,
                        shard_id=shard_id)
    return dataset, loader
