"""Semi-supervised KITTI dataset (VirConv-S): the train split plus
pseudo-labelled odometry frames.

The port's copy of ``virconv_tpu/datasets/kitti/kitti_dataset_semi.py``.
Sample ids are ``[subdir, frame]`` pairs mixing ``training/`` and ``semi/``
(frames that ``tools/create_semi_dataset.py`` lays out and a trained
VirConv-T labels). Each info carries a ``split`` field, and the frame's raw
data (fused points, calibration) is read from that subdirectory; only
``training/`` frames carry a road plane for the gt sampler. An index whose
sample is left without gt boxes is replaced by a random one, drawn from the
dataset's ``RandomState`` where the JAX dataset draws from numpy's global
state.
"""

from __future__ import annotations

from .kitti_dataset_mm import KittiDatasetMM

TRAINING = 'training'


class KittiDatasetSemi(KittiDatasetMM):
    def __init__(self, dataset_cfg, class_names, training=True,
                 root_path=None, logger=None, seed=0):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path,
                         logger=logger, seed=seed)
        self.sample_id_list = self.include_id_list()

    def include_id_list(self):
        """``[subdir, frame]`` of the split: a plain split from its own
        subdirectory; ``trainsemi`` / ``trainvalsemi`` the train / trainval
        frames of ``training/`` then the ``semi/`` frames."""
        def read(name):
            p = self.root_path / 'ImageSets' / f'{name}.txt'
            return [x.strip() for x in open(p).readlines()] if p.exists() \
                else []

        split = self.split
        if split in ('train', 'val', 'trainval', 'test', 'semi'):
            sub = {'test': 'testing', 'semi': 'semi'}.get(split, TRAINING)
            return [[sub, i] for i in read(split)]
        if split in ('trainsemi', 'trainvalsemi'):
            base = 'train' if split == 'trainsemi' else 'trainval'
            return ([[TRAINING, i] for i in read(base)]
                    + [['semi', i] for i in read('semi')])
        return None

    def frame_root(self, info):
        return self.root_path / info.get('split', TRAINING)

    def get_road_plane(self, idx, root=None):
        if root is not None and root.name != TRAINING:
            return None
        return super().get_road_plane(idx, root)
