"""Host time of the training loader, split by stage, alone and beside
training steps on the card.

    python3 -m virconv_tpu_torch.profile_loader [--frames 16] [--train] \\
        [--out chiprun_out]

Writes a ``scene`` KITTI tree of ``--frames`` training frames (with its gt
database) in a temporary directory, then:

1. runs one epoch of the full-width VirConv-T training loader (batches of
   2 frames) with nothing else running, and reports its host seconds per
   frame and each stage's seconds per frame: loading the cloud, the FOV
   crop, each augmentor of ``DATA_AUGMENTOR`` (gt sampling, DA sampling,
   local noise, world rotation, flip and scaling, local translation,
   pyramid augmentations), the scene swap, StVD, the feature encoder and
   the processors, the collation, and the rest of ``__getitem__``;
2. with ``--train``, runs ``tools/train_gpu.py`` for one epoch on CUDA over
   the same tree (``--no_eval``) and reports the same split under
   training, the seconds of each step and of each wait for a batch, and
   the share of the loop spent waiting on the loader after the first
   step.

The stage timers wrap the dataset's methods at class level and read the
host clock in the loader's producer thread; a stage's seconds include any
time that thread waits for the interpreter lock. Prints one JSON line and
writes it to ``<out>/loader_profile.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

AUGMENTORS = ('random_local_noise', 'random_world_rotation',
              'random_world_flip', 'random_world_scaling',
              'random_local_trans', 'random_local_pyramid_aug')


class StageTimer(contextlib.AbstractContextManager):
    """Seconds and calls per stage of the training loader, from wrappers
    put on the loader's classes (and taken off on exit)."""

    def __init__(self):
        self.seconds, self.calls, self._undo = {}, {}, []

    def add(self, name, dt):
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
        self.calls[name] = self.calls.get(name, 0) + 1

    def wrap(self, cls, attr, name=None, static=False, skip_none=False):
        orig = cls.__dict__[attr]
        fn = orig.__func__ if static else orig

        def timed(*a, **k):
            if skip_none and k.get('data_dict', a[1] if len(a) > 1 else
                                   None) is None:
                return fn(*a, **k)
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                label = name(a[0]) if callable(name) else (name or attr)
                self.add(label, time.perf_counter() - t)
        setattr(cls, attr, staticmethod(timed) if static else timed)
        self._undo.append((cls, attr, orig))

    def __enter__(self):
        from .datasets import DataLoader
        from .datasets.augmentor.data_augmentor import DataAugmentor
        from .datasets.augmentor.database_sampler import DataBaseSampler
        from .datasets.dataset import DatasetTemplate
        from .datasets.kitti.kitti_dataset_mm import KittiDatasetMM
        from .datasets.processor.data_processor import DataProcessor
        from .datasets.processor.point_feature_encoder import \
            PointFeatureEncoder
        self.wrap(DataLoader, '_sample', 'sample')
        self.wrap(DatasetTemplate, 'collate_batch', 'collate')
        self.wrap(KittiDatasetMM, 'get_lidar_mm', 'load')
        self.wrap(KittiDatasetMM, 'get_fov_flag', 'fov_crop', static=True)
        self.wrap(DataBaseSampler, '__call__', lambda s: (
            'da_sampling' if type(s).__name__.startswith('DA')
            else 'gt_sampling'))
        for attr in AUGMENTORS:
            self.wrap(DataAugmentor, attr, skip_none=True)
        self.wrap(DatasetTemplate, 'scene_swap')
        self.wrap(DatasetTemplate, 'input_point_discard', 'stvd')
        self.wrap(PointFeatureEncoder, 'forward', 'encoder')
        self.wrap(DataProcessor, 'forward', 'processors')
        return self

    def __exit__(self, *exc):
        for cls, attr, orig in reversed(self._undo):
            setattr(cls, attr, orig)
        return False

    def split(self, frames):
        """Seconds per frame by stage; ``rest`` is the part of ``sample``
        no stage covers (``__getitem__``'s own work: the info copy, the
        calibration and label boxes, the class column)."""
        per = {k: v / frames for k, v in self.seconds.items()}
        parts = sum(v for k, v in per.items() if k not in ('sample',
                                                            'collate'))
        per['rest'] = per.get('sample', 0.0) - parts
        return per


def loader_alone(cfg, batch_size, seed):
    from .datasets import build_dataloader
    with StageTimer() as timer:     # before the augmentors bind methods
        _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size, seed=seed, training=True)
        t = time.perf_counter()
        n = sum(b['points'].shape[0] for b, _ in loader)
        wall = time.perf_counter() - t
    return {'frames': n, 'sec_per_frame': loader.host_seconds / n,
            'wall_s': wall, 'split_sec_per_frame': timer.split(n),
            'calls': timer.calls}


def loader_under_training(root, batch_size):
    root_dir = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root_dir / 'tools'))
    import train_gpu
    with tempfile.TemporaryDirectory() as out, StageTimer() as timer:
        run = train_gpu.main(['--cfg', 'virconv_t', '--epochs', '1',
                              '--batch_size', str(batch_size), '--no_eval',
                              '--fix_random_seed', '--log_interval',
                              '1000', '--output_dir', out, '--set',
                              'DATA_CONFIG.DATA_PATH', str(root)])
    steps = run.steps
    after = steps[1:]
    busy = sum(s['seconds'] + s['wait'] for s in after)
    return {'frames': run.frames,
            'sec_per_frame': run.loader_seconds / run.frames,
            'split_sec_per_frame': timer.split(run.frames),
            'step_s': [s['seconds'] for s in steps],
            'wait_s': [s['wait'] for s in steps],
            'wait_share': run.wait_seconds / run.wall_seconds,
            'wait_share_after_first': sum(s['wait'] for s in after)
            / max(busy, 1e-9)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--frames', type=int, default=16)
    ap.add_argument('--batch_size', type=int, default=2)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--train', action='store_true')
    ap.add_argument('--out', default='chiprun_out')
    a = ap.parse_args(argv)
    from .config import virconv_t_config
    from .utils.mini_kitti import write_tree
    res = {'frames': a.frames, 'batch_size': a.batch_size}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        root = write_tree(Path(tmp) / 'kitti', 'scene', frames=a.frames,
                          seed=a.seed, n_train=a.frames)
        res['tree_write_s'] = time.perf_counter() - t
        cfg = virconv_t_config()
        cfg.DATA_CONFIG.DATA_PATH = str(root)
        res['alone'] = loader_alone(cfg, a.batch_size, a.seed)
        if a.train:
            res['training'] = loader_under_training(root, a.batch_size)
    line = json.dumps(res)
    print(line, flush=True)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / 'loader_profile.json').write_text(line + '\n')
    return res


if __name__ == '__main__':
    main()
