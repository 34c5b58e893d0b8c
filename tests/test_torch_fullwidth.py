"""The full-width multi-rank run (``virconv_tpu_torch/parallel/fullwidth.
py``, CLI ``tools/run_fullwidth_dp_gpu.py``) against
``tools/run_fullwidth_mesh.py``, on the CPU.

(a) ``tool_batches`` gives, bit for bit, the training and evaluation
batches the JAX tool builds, here for 2 frames: the tool's ``synth``
closure and gt boxes (tools/run_fullwidth_mesh.py:118-162) and its
replicated evaluation batch (:186-220) are rebuilt below from the JAX
package's ``make_scene`` and ``Calibration`` (numpy only, no JAX compile).
(b) ``run_fullwidth`` at the tiny preset (``tiny_train_config`` with the
loader's ROT_NUM the ROI head's 2), 2 ranks over gloo, 2 frames: its JSON
record has the JAX tool's fields and the port's (``device``, ``backend``,
per-rank ``peak_gib``, ``step_s``, ``sync_bn_ms``, ``grad_allreduce_ms``),
its gates hold (2 dicts, a finite loss, the ranks' parameters and
buffers the same bits after the step, finite boxes, at least one merged
detection; the launch gates count CUDA launches and so run on the card
only), and its merged prediction dicts equal one process's evaluation of
the same entries from rank 0's trained weights under the rule of the
port's distributed evaluation (the same detection counts per frame, boxes
within 5e-3, scores within 2e-3). The tiny preset's random weights give
32 detections on each frame (its score threshold passes every ROI),
which the test holds too.
"""
import numpy as np

JAX_FIELDS = {'what', 'devices', 'train_frames', 'eval_entries', 'loss',
              'dets_per_frame', 'train_done_s', 'total_s', 'data_caps',
              'ok'}


def jax_tool_batches(frames, n_rep=3):
    """The JAX tool's two batches, built as tools/run_fullwidth_mesh.py
    builds them (its closure copied, its module not imported: it starts
    JAX on import)."""
    from virconv_tpu.utils.calibration import Calibration
    from virconv_tpu.utils.synth_scene import make_scene
    n_lpts, n_pts = 8192, 16384
    rng = np.random.default_rng(0)
    p2 = np.array([[721.5, 0., 609.6, 44.9],
                   [0., 721.5, 172.9, 0.2],
                   [0., 0., 1., 0.003]], np.float32)
    v2c = np.array([[7.5e-03, -1.0, -1.8e-04, -4.1e-03],
                    [2.0e-03, 1.9e-04, -1.0, -7.6e-02],
                    [1.0, 7.5e-03, 2.0e-03, -2.7e-01]], np.float32)
    calib = Calibration({'P2': p2, 'R0': np.eye(3, dtype=np.float32),
                         'Tr_velo2cam': v2c})
    v2r, p2t = calib.device_matrices()

    def synth(n_entries):
        lpts = np.zeros((n_entries, n_lpts, 8), np.float32)
        lval = np.zeros((n_entries, n_lpts), bool)
        mpts = np.zeros((n_entries, n_pts, 8), np.float32)
        mval = np.zeros((n_entries, n_pts), bool)
        gts = []
        for e in range(n_entries):
            s = make_scene(seed=e)
            lidar8 = np.concatenate(
                [s['lidar'][:, :4],
                 np.zeros((len(s['lidar']), 3), np.float32),
                 np.ones((len(s['lidar']), 1), np.float32)], -1)
            if len(lidar8) > n_lpts:
                lidar8 = lidar8[rng.choice(len(lidar8), n_lpts,
                                           replace=False)]
            fused = np.concatenate([lidar8, s['virtual']], 0)
            if len(fused) > n_pts:
                fused = fused[rng.choice(len(fused), n_pts, replace=False)]
            lpts[e, :len(lidar8)] = lidar8
            lval[e, :len(lidar8)] = True
            mpts[e, :len(fused)] = fused
            mval[e, :len(fused)] = True
            gts.append(s.get('boxes'))
        return lpts, lval, mpts, mval, gts

    lpts, lval, mpts, mval, gts = synth(frames)
    gt = np.zeros((frames, 64, 8), np.float32)
    gt_valid = np.zeros((frames, 64), bool)
    for e, g in enumerate(gts):
        if g is None or len(g) == 0:
            g = np.array([[20, 0, -1, 3.9, 1.6, 1.56, 0.3]], np.float32)
        k = min(len(g), 64)
        gt[e, :k, :7] = g[:k, :7]
        gt[e, :k, 7] = 1
        gt_valid[e, :k] = True
    train_batch = {
        'points': lpts, 'points_valid': lval,
        'points_mm': mpts, 'points_mm_valid': mval,
        'v2r': np.tile(v2r, (frames, 1, 1)),
        'p2t': np.tile(p2t, (frames, 1, 1)),
        'transform_param': None,
        'trans_params': np.tile(np.array([[0.1, 1.0, 1.01]], np.float32),
                                (frames, 1)),
        'gt_boxes': gt, 'gt_valid': gt_valid,
    }
    params_rep = np.array([[0.3, 0.0, 0.98], [0.3, 1.0, 1.02],
                           [0.0, 1.0, 1.0]], np.float32)[:n_rep]
    elp, elv, emp, emv, _ = synth(frames)

    def world_transform(p, prm):
        rot, flip, scale = prm
        q = p.copy()
        ca, sa = np.cos(rot), np.sin(rot)
        x, y = q[..., 0].copy(), q[..., 1].copy()
        q[..., 0] = ca * x - sa * y
        q[..., 1] = sa * x + ca * y
        if flip == 1:
            q[..., 1] = -q[..., 1]
        q[..., :3] *= scale
        return q

    def replicate(pts):
        reps = np.stack([world_transform(pts, p) for p in params_rep], 1)
        return reps.reshape(frames * n_rep, *pts.shape[1:])

    eval_batch = {
        'points': replicate(elp),
        'points_valid': np.repeat(elv, n_rep, axis=0),
        'points_mm': replicate(emp),
        'points_mm_valid': np.repeat(emv, n_rep, axis=0),
        'v2r': np.tile(v2r, (frames * n_rep, 1, 1)),
        'p2t': np.tile(p2t, (frames * n_rep, 1, 1)),
        'transform_param': np.tile(params_rep[None], (frames, 1, 1)),
        'trans_params': np.tile(params_rep, (frames, 1)),
        'gt_boxes': None, 'gt_valid': None,
    }
    return train_batch, eval_batch


def test_tool_batches_are_the_jax_tools():
    from virconv_tpu_torch.parallel.fullwidth import tool_batches
    got = tool_batches(2, 3)
    want = jax_tool_batches(2, 3)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if v is None:
                assert g[k] is None, k
                continue
            assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
            assert g[k].tobytes() == v.tobytes(), k


def test_tiny_preset_on_two_ranks_merges_as_one_process():
    from virconv_tpu_torch.configs.tiny import tiny_train_config
    from virconv_tpu_torch.parallel.fullwidth import (compare_preds,
                                                      one_process_eval,
                                                      run_fullwidth)
    cfg = tiny_train_config()
    cfg.DATA_CONFIG.ROT_NUM = cfg.MODEL.ROI_HEAD.ROT_NUM
    rec, det = run_fullwidth(2, 'cpu', cfg=cfg, frames=2, timeout=300)
    assert set(rec) == JAX_FIELDS | {'device', 'backend', 'peak_gib',
                                     'step_s', 'sync_bn_ms',
                                     'grad_allreduce_ms'}
    assert rec['ok'] and rec['devices'] == 2 and rec['backend'] == 'gloo'
    assert rec['device'] == 'cpu'
    assert rec['train_frames'] == 2 and rec['eval_entries'] == 4
    assert np.isfinite(rec['loss'])
    assert rec['data_caps'] == {'voxels': 2048, 'lidar_pts': 8192,
                                'mm_pts': 16384}
    assert all(len(rec[k]) == 2 for k in ('step_s', 'peak_gib',
                                          'sync_bn_ms', 'grad_allreduce_ms'))
    assert 0 < rec['train_done_s'] <= rec['total_s']
    assert rec['dets_per_frame'] == [32, 32]
    ranks = det['ranks']
    assert [r['state_dict'] is None for r in ranks] == [False, True]
    assert ranks[0]['state_digest'] == ranks[1]['state_digest']
    for r in ranks:
        assert r['train']['collectives']['grads']['calls'] == 1
    want = one_process_eval(det['cfg'], ranks[0]['state_dict'],
                            det['eval_batch'], 2, 'cpu')
    cmp = compare_preds(det['pred_dicts'], want)
    assert cmp['agree'], cmp
