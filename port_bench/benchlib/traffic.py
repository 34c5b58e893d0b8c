"""The one traffic generator: a traffic mix is a JSON file of parameters
(``traffic/<name>.json``), read here for any configuration.

Keys: ``mode`` ('infer' or 'train'), ``frames`` per request or step,
``cars`` per scene, ``pool`` (scenes made at set-up), ``yaw`` (the largest
|rotation| in radians of a frame's fresh global yaw), ``flip`` (chance of a
mirror across the x axis), ``keep`` (chance that a point survives the
subsample), and the per-stream point capacities: ``lidar_points`` and
``fused_points`` (serving), ``points`` (training), with ``gt_max`` boxes a
training frame, and ``total_steps`` (the length of the learning-rate
schedule). A single-stream configuration (no ``MM`` backbone) takes
StVD on its virtual points at ``stvd_rate`` over ``stvd_bins_infer`` or
``stvd_bins_train`` distance bins, as its loader does.

Everything is drawn from ``--seed``: the pool's scene seeds, and for item
i a generator seeded (seed, i) that picks the frames and draws their yaw,
flip and subsample. One seed gives the same items; no two items share
their points.
"""

from __future__ import annotations

import numpy as np

from . import streets


class Traffic:
    def __init__(self, params: dict, cfg, seed: int):
        self.p = dict(params)
        self.seed = int(seed)
        self.mm = bool(cfg['MODEL']['BACKBONE_3D'].get('MM', False))
        self.rot_num = int(cfg['MODEL']['ROI_HEAD']['ROT_NUM'])
        self.mode = self.p['mode']
        if self.mode not in ('infer', 'train'):
            raise ValueError(f'traffic mode {self.mode!r}')
        rng = np.random.default_rng([self.seed, 2 ** 32])
        scene_seeds = rng.integers(0, 2 ** 62, int(self.p['pool']))
        self.scenes = [streets.make_scene(seed=int(s),
                                          n_cars=int(self.p['cars']))
                       for s in scene_seeds]
        self.v2r, self.p2t = streets.kitti_calib()

    @property
    def frames(self) -> int:
        return int(self.p['frames'])

    def _frame(self, r, k):
        """Scene k under a fresh yaw, flip and subsample drawn from r."""
        s = self.scenes[k]
        param = np.array([r.uniform(-self.p['yaw'], self.p['yaw']),
                          float(r.random() < self.p['flip']), 1.0],
                         np.float32)
        keep_l = r.random(len(s['lidar'])) < self.p['keep']
        keep_v = r.random(len(s['virtual'])) < self.p['keep']
        return {'lidar': streets.transform_points_np(s['lidar'][keep_l],
                                                     param),
                'virtual': streets.transform_points_np(
                    s['virtual'][keep_v], param),
                'boxes': streets.transform_boxes_np(s['boxes'], param)}

    @staticmethod
    def _cap(pts, n, r):
        if len(pts) > n:
            pts = pts[np.sort(r.choice(len(pts), n, replace=False))]
        return pts

    @staticmethod
    def _pad(streams, n):
        pts = np.zeros((len(streams), n, 8), np.float32)
        valid = np.zeros((len(streams), n), bool)
        for e, s in enumerate(streams):
            pts[e, :len(s)] = s
            valid[e, :len(s)] = True
        return pts, valid

    def _single_stream(self, scene, r, n, bins):
        cloud = streets.fused_cloud(scene)
        kept = streets.input_point_discard(
            cloud[cloud[:, 7] == streets.VIRTUAL],
            np.random.RandomState(r.integers(0, 2 ** 31)), bin_num=bins,
            rate=self.p['stvd_rate'])
        fused = streets.fuse_streams(cloud[cloud[:, 7] == streets.LIDAR],
                                     kept)
        return self._cap(fused, n, r)

    def size(self, i: int) -> int:
        """Points of the scenes item ``i`` picks, before its subsample: the
        length of the item's work, known without building it."""
        r = np.random.default_rng([self.seed, int(i)])
        picks = r.choice(len(self.scenes), self.frames, replace=False)
        return sum(len(self.scenes[k]['lidar']) + len(self.scenes[k]['virtual'])
                   for k in picks)

    def item(self, i: int) -> dict:
        """Request or step ``i``: the serving frames (``Detector`` input) or
        the training batch (``Trainer.step`` input)."""
        r = np.random.default_rng([self.seed, int(i)])
        picks = r.choice(len(self.scenes), self.frames, replace=False)
        scenes = [self._frame(r, int(k)) for k in picks]
        return self._infer(scenes, r) if self.mode == 'infer' \
            else self._train(scenes, r)

    def _infer(self, scenes, r):
        f = len(scenes)
        out = {'v2r': np.tile(self.v2r, (f, 1, 1)),
               'p2t': np.tile(self.p2t, (f, 1, 1))}
        if self.mm:
            nl, nf = int(self.p['lidar_points']), int(self.p['fused_points'])
            lid, fus = [], []
            for s in scenes:
                l8 = self._cap(streets.lidar8(s), nl, r)
                lid.append(l8)
                fus.append(self._cap(np.concatenate([l8, s['virtual']]),
                                     nf, r))
            out['points'], out['points_valid'] = self._pad(lid, nl)
            out['points_mm'], out['points_mm_valid'] = self._pad(fus, nf)
        else:
            nf = int(self.p['fused_points'])
            out['points'], out['points_valid'] = self._pad(
                [self._single_stream(s, r, nf, int(self.p['stvd_bins_infer']))
                 for s in scenes], nf)
        return out

    def _train(self, scenes, r):
        f = len(scenes)
        n, m = int(self.p['points']), int(self.p['gt_max'])
        gt = np.zeros((f, m, 8), np.float32)
        gt_valid = np.zeros((f, m), bool)
        for e, s in enumerate(scenes):
            boxes = s['boxes'][:m]
            gt[e, :len(boxes), :7] = boxes[:, :7]
            gt[e, :len(boxes), 7] = 1
            gt_valid[e, :len(boxes)] = True
        if self.mm:
            lid, fus = [], []
            for s in scenes:
                l8 = self._cap(streets.lidar8(s), n, r)
                lid.append(l8)
                fus.append(self._cap(np.concatenate([l8, s['virtual']]), n,
                                     r))
            lpts, lval = self._pad(lid, n)
            mpts, mval = self._pad(fus, n)
            params = streets.TRAIN_TRANSFORMS[:self.rot_num]

            def replicate(arr, fn):
                return np.stack([fn(arr[e], p) for e in range(f)
                                 for p in params])
            k = len(params)
            entries = f * k
            return {'points': replicate(lpts, streets.transform_points_np),
                    'points_valid': np.repeat(lval, k, 0),
                    'points_mm': replicate(mpts, streets.transform_points_np),
                    'points_mm_valid': np.repeat(mval, k, 0),
                    'v2r': np.tile(self.v2r, (entries, 1, 1)),
                    'p2t': np.tile(self.p2t, (entries, 1, 1)),
                    'trans_params': np.tile(params, (f, 1)),
                    'transform_param': None,
                    'gt_boxes': replicate(gt, streets.transform_boxes_np),
                    'gt_valid': np.repeat(gt_valid, k, 0)}
        p = streets.TRAIN_TRANSFORMS[0]
        streams = [streets.transform_points_np(
            self._single_stream(s, r, n, int(self.p['stvd_bins_train'])), p)
            for s in scenes]
        pts, valid = self._pad(streams, n)
        for e in range(f):
            gt[e, gt_valid[e], :7] = streets.transform_boxes_np(
                gt[e, gt_valid[e], :7], p)
        return {'points': pts, 'points_valid': valid,
                'v2r': np.tile(self.v2r, (f, 1, 1)),
                'p2t': np.tile(self.p2t, (f, 1, 1)),
                'trans_params': np.tile(p[None], (f, 1)),
                'transform_param': None, 'gt_boxes': gt,
                'gt_valid': gt_valid}
