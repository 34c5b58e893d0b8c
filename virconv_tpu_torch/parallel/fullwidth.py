"""The full-width VirConv-T model trained one step and evaluated over W
data-parallel ranks: the port's counterpart of
``tools/run_fullwidth_mesh.py`` (its CLI is ``tools/run_fullwidth_dp_gpu.
py``).

The JAX tool runs the published VirConv-T config (every width, layer,
grid, ROI count and NMS size) on an 8-device data-parallel mesh: one
training step over 8 synthetic KITTI-scale frames, a frame per device,
then the evaluation of the same number of frames x ROT_NUM 3 test-time
replicas, 3 entries per device, merged through the host tail
(``post_process_batch``). Its only cuts are host data budgets: 10 000
voxels per entry, 8192 LiDAR and 16 384 fused points per entry. This
module builds the same inputs from the port's copies of ``make_scene`` and
``Calibration`` (``tool_batches``: the same calibration, the same seeded
subsampling in the same call order, the same gt boxes and transforms),
and runs both steps in the same W rank processes (``parallel/spawn.
run_ranks``): rank r takes frames ``[r F / W, (r + 1) F / W)`` through
``Trainer(dist=True)`` (sync-BN, global loss normalizers, the gradient
all-reduce), then evaluates its frames' replicas with the trained model
(eval mode, no gradients, no collectives). The parent concatenates the
outputs in rank order and runs ``post_process_batch``.

Gates (``RuntimeError``): one prediction dict per frame, a finite loss,
the same loss and the same parameter and buffer bits on every rank after
the step (a digest of each rank's ``state_dict``), finite boxes, at least
one merged detection, and on CUDA every rank's launches of K1, K4 and
``gather_rows`` in training and of K1 and K2+K3 in evaluation (the
wrappers count CUDA launches only). Backend and devices follow ``spawn.rank_backend``: nccl puts rank r
on ``cuda:r``, gloo every rank on ``cuda:0`` (several ranks on one card)
or on the CPU.

``one_process_eval`` evaluates the same entries in one process from rank
0's trained weights, a rank's share per forward (the voxel and downsample
caps are per forward, so a forward of all entries could keep other
voxels), and ``compare_preds`` holds two lists of prediction dicts to
each other. Since both sides run a rank's share per forward, the two
agree when every rank evaluated with rank 0's weights and the merge kept
rank order; a fault in how the entries are split shows on both alike.
"""

from __future__ import annotations

import time

import numpy as np

FRAMES = 8
N_LIDAR_PTS, N_FUSED_PTS = 8192, 16384     # points per entry and stream
MAX_VOXELS = 10000                          # per entry, train and test
N_GT = 64
# the JAX tool's optimizer: one-cycle Adam at LR 0.003 over 10 steps
FULLWIDTH_OPT = {'OPTIMIZER': 'adam_onecycle', 'LR': 0.003,
                 'WEIGHT_DECAY': 0.01, 'MOMS': [0.95, 0.85],
                 'PCT_START': 0.4, 'DIV_FACTOR': 10, 'GRAD_NORM_CLIP': 10,
                 'NUM_EPOCHS': 1}
TOTAL_STEPS = 10
# the evaluation's test-time replicas [rot, flip, scale]
EVAL_TRANSFORMS = np.array([[0.3, 0.0, 0.98], [0.3, 1.0, 1.02],
                            [0.0, 1.0, 1.0]], np.float32)
# the gt box of a training frame whose scene has none
STAND_IN_BOX = np.array([[20, 0, -1, 3.9, 1.6, 1.56, 0.3]], np.float32)
# the model outputs the host tail reads
EVAL_KEYS = ('batch_box_preds', 'batch_cls_preds', 'roi_valid')


def fullwidth_config():
    """The published VirConv-T config with the JAX tool's host data
    budgets (``MAX_VOXELS`` per entry in training and evaluation) and
    optimizer; every model setting as shipped."""
    from ..config import virconv_t_config
    cfg = virconv_t_config()
    for p in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if p.NAME == 'transform_points_to_voxels':
            p.MAX_NUMBER_OF_VOXELS = {'train': MAX_VOXELS,
                                      'test': MAX_VOXELS}
    cfg.OPTIMIZATION.update(FULLWIDTH_OPT)
    return cfg


def _synth(n_entries, rng):
    """The JAX tool's ``synth``: scene e (``make_scene(seed=e)``) as an
    8-column LiDAR stream of at most ``N_LIDAR_PTS`` points and a fused
    stream (LiDAR then virtual points) of at most ``N_FUSED_PTS``, each
    subsampled without replacement from ``rng``; with each scene's gt
    boxes."""
    from ..utils.synth_scene import make_scene
    n_lpts, n_pts = N_LIDAR_PTS, N_FUSED_PTS
    lpts = np.zeros((n_entries, n_lpts, 8), np.float32)
    lval = np.zeros((n_entries, n_lpts), bool)
    mpts = np.zeros((n_entries, n_pts, 8), np.float32)
    mval = np.zeros((n_entries, n_pts), bool)
    gts = []
    for e in range(n_entries):
        s = make_scene(seed=e)
        lidar8 = np.concatenate(
            [s['lidar'][:, :4], np.zeros((len(s['lidar']), 3), np.float32),
             np.ones((len(s['lidar']), 1), np.float32)], -1)
        if len(lidar8) > n_lpts:
            lidar8 = lidar8[rng.choice(len(lidar8), n_lpts, replace=False)]
        fused = np.concatenate([lidar8, s['virtual']], 0)
        if len(fused) > n_pts:
            fused = fused[rng.choice(len(fused), n_pts, replace=False)]
        lpts[e, :len(lidar8)] = lidar8
        lval[e, :len(lidar8)] = True
        mpts[e, :len(fused)] = fused
        mval[e, :len(fused)] = True
        gts.append(s.get('boxes'))
    return lpts, lval, mpts, mval, gts


def _world_transform(p, prm):
    """The JAX tool's replica transform of points: rotation about z, then
    the y flip, then the scale."""
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


def tool_batches(frames=FRAMES, n_rep=3):
    """(training batch, evaluation batch) as the JAX tool builds them, from
    one ``default_rng(0)`` in its call order: ``frames`` entries of one
    replica each with up to ``N_GT`` gt boxes (``STAND_IN_BOX`` for a
    scene with none) and ``trans_params`` [0.1, 1, 1.01]; then a second
    ``_synth(frames)`` replicated by the first ``n_rep`` of
    ``EVAL_TRANSFORMS`` (entry = frame * n_rep + replica) with
    ``transform_param`` tiled."""
    from ..utils.bench_inputs import kitti_calib
    rng = np.random.default_rng(0)
    v2r, p2t = kitti_calib()
    lpts, lval, mpts, mval, gts = _synth(frames, rng)
    gt = np.zeros((frames, N_GT, 8), np.float32)
    gt_valid = np.zeros((frames, N_GT), bool)
    for e, g in enumerate(gts):
        if g is None or len(g) == 0:
            g = STAND_IN_BOX
        k = min(len(g), N_GT)
        gt[e, :k, :7] = g[:k, :7]
        gt[e, :k, 7] = 1
        gt_valid[e, :k] = True
    train = {'points': lpts, 'points_valid': lval, 'points_mm': mpts,
             'points_mm_valid': mval,
             'v2r': np.tile(v2r, (frames, 1, 1)),
             'p2t': np.tile(p2t, (frames, 1, 1)),
             'transform_param': None,
             'trans_params': np.tile(np.array([[0.1, 1.0, 1.01]],
                                              np.float32), (frames, 1)),
             'gt_boxes': gt, 'gt_valid': gt_valid}
    params = EVAL_TRANSFORMS[:n_rep]
    elp, elv, emp, emv, _ = _synth(frames, rng)

    def replicate(pts):
        reps = np.stack([_world_transform(pts, p) for p in params], 1)
        return reps.reshape(frames * n_rep, *pts.shape[1:])
    evaluation = {
        'points': replicate(elp),
        'points_valid': np.repeat(elv, n_rep, axis=0),
        'points_mm': replicate(emp),
        'points_mm_valid': np.repeat(emv, n_rep, axis=0),
        'v2r': np.tile(v2r, (frames * n_rep, 1, 1)),
        'p2t': np.tile(p2t, (frames * n_rep, 1, 1)),
        'transform_param': np.tile(params[None], (frames, 1, 1)),
        'trans_params': np.tile(params, (frames, 1)),
        'gt_boxes': None, 'gt_valid': None}
    return train, evaluation


def state_digest(module):
    """sha256 of ``module``'s ``state_dict``: every parameter's and
    buffer's name, dtype, shape and bytes, in order."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        v = v.detach().cpu().contiguous()
        h.update(f'{k} {v.dtype} {tuple(v.shape)}'.encode())
        h.update(v.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def fullwidth_rank(rank, world, payload):
    """Rank ``rank``'s training step on its frames of ``payload['train']``,
    then its evaluation of its frames' entries of ``payload['eval']`` with
    the trained model (module docstring); every launch count set to 0 just
    before each and read just after (``spawn.reset_launches``,
    ``launch_counts``). The step's collectives are timed
    (``data_parallel.TIMING``: each synchronizes the device), so its
    seconds include those waits. Returns the global loss, the step's
    seconds, peak memory, collectives and launches, the evaluation's
    outputs (CPU), seconds, peak memory and launches, the trained model's
    ``state_digest``, and on rank 0 its ``state_dict`` (CPU)."""
    import torch
    from ..train.trainer import Trainer
    from . import data_parallel as dp
    from .spawn import launch_counts, rank_device, reset_launches
    device = rank_device(payload['device'], rank)
    cuda = device.startswith('cuda')
    if cuda:
        torch.cuda.set_device(torch.device(device))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def start():
        reset_launches()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def peak():
        return torch.cuda.max_memory_allocated() if cuda else None

    trainer = Trainer(payload['cfg'], device=device, seed=0,
                      total_steps=TOTAL_STEPS, dist=True)
    share = dp.shard_frames(payload['train'], rank, world,
                            entries_per_frame=1)
    dp.reset_counts()
    dp.TIMING = True
    t0 = start()
    loss, _ = trainer.step(share)
    loss = float(loss)
    if cuda:
        torch.cuda.synchronize()
    train = {'loss': loss, 'seconds': time.perf_counter() - t0,
             'done_at': time.time(), 'peak_bytes': peak(),
             'collectives': {k: {**v, 'seconds': dp.SECONDS[k]}
                             for k, v in dp.COUNTS.items()},
             'launches': launch_counts()}
    dp.TIMING = False

    model = trainer.model.eval()
    batch = trainer.to_device(dp.shard_frames(payload['eval'], rank,
                                              world))
    t0 = start()
    with torch.no_grad():
        out = model(batch)
    out = {k: out[k].cpu() for k in EVAL_KEYS}
    evaluation = {'outputs': out, 'seconds': time.perf_counter() - t0,
                  'peak_bytes': peak(),
                  'launches': launch_counts()}
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()} if rank == 0 else None
    return {'train': train, 'eval': evaluation,
            'state_digest': state_digest(model), 'state_dict': state}


def merge_outputs(outputs):
    """The ranks' evaluation outputs concatenated in rank order."""
    import torch
    return {k: torch.cat([o[k] for o in outputs]) for k in EVAL_KEYS}


def _gate(ok, msg):
    if not ok:
        raise RuntimeError(f'fullwidth: {msg}')


def run_fullwidth(ranks=8, device='cuda', backend=None, cfg=None,
                  frames=FRAMES, timeout=1800.0):
    """The JAX tool's run on ``ranks`` ranks (module docstring).
    ``cfg``: ``fullwidth_config()`` by default (a test passes a tiny
    config). Returns (the JSON record: the JAX tool's fields, the card's
    name, the backend, and per rank the step's peak GiB, seconds and its
    sync-BN and gradient all-reduce ms; the details: each rank's result,
    the prediction dicts, the config and the evaluation batch). Raises when
    a gate fails."""
    import torch
    from ..config import CfgNode
    from ..utils.postprocess import post_process_batch
    from .spawn import rank_backend, run_ranks
    t_start = time.time()

    def progress(msg):
        print(f'[fullwidth +{time.time() - t_start:7.1f}s] {msg}',
              flush=True)

    backend, rank_dev = rank_backend(ranks, device, backend)
    cfg = cfg if cfg is not None else fullwidth_config()
    n_rep = cfg.DATA_CONFIG.ROT_NUM
    caps = cfg.DATA_CONFIG.DATA_PROCESSOR
    voxels = next(p.MAX_NUMBER_OF_VOXELS for p in caps
                  if p.NAME == 'transform_points_to_voxels')
    train, evaluation = tool_batches(frames, n_rep)
    progress(f'{frames} training frames, {frames * n_rep} evaluation '
             f'entries built; {ranks} ranks over {backend} on {rank_dev} '
             '(nccl: rank r on cuda:r; gloo shares one card)')
    results = run_ranks(fullwidth_rank, ranks, {
        'cfg': cfg, 'train': train, 'eval': evaluation,
        'device': rank_dev}, backend=backend, timeout=timeout)
    loss = results[0]['train']['loss']
    train_done = max(r['train']['done_at'] for r in results) - t_start
    progress(f'train step done on every rank: loss={loss:.4f}; '
             'running the host merge tail')
    pred_dicts = post_process_batch(
        merge_outputs([r['eval']['outputs'] for r in results]),
        CfgNode(cfg.MODEL.POST_PROCESSING), len(cfg.CLASS_NAMES))
    n_dets = [int((p['pred_scores'] > 0).sum()) for p in pred_dicts]
    finite = all(np.isfinite(p['pred_boxes']).all() for p in pred_dicts)
    progress(f'merged detections/frame: {n_dets} (finite={finite})')

    _gate(len(pred_dicts) == frames,
          f'{len(pred_dicts)} prediction dicts for {frames} frames')
    _gate(np.isfinite(loss), f'loss {loss}')
    _gate(all(r['train']['loss'] == loss for r in results),
          'the ranks returned other global losses')
    _gate(len({r['state_digest'] for r in results}) == 1,
          'the ranks hold other parameters or buffers after the step')
    _gate(finite, 'non-finite boxes')
    _gate(sum(n_dets) > 0, 'no detections survived the merge')
    if rank_dev != 'cpu':
        for r, res in enumerate(results):
            tr, ev = res['train']['launches'], res['eval']['launches']
            _gate(tr['band_conv_fwd'] and tr['band_conv_dw']
                  and tr['gather_rows'], f'rank {r} missed a training '
                  f'kernel: {tr}')
            _gate(ev['band_conv_fwd'] and ev['roi_pool_fwd'],
                  f'rank {r} missed an evaluation kernel: {ev}')

    def gib(b):
        return None if b is None else b / 2 ** 30

    def coll_ms(r, kind):
        return r['train']['collectives'][kind]['seconds'] * 1e3
    rec = {'what': f'fullwidth_{ranks}rank_dp', 'devices': ranks,
           'train_frames': frames, 'eval_entries': frames * n_rep,
           'loss': loss, 'dets_per_frame': n_dets,
           'train_done_s': train_done, 'total_s': time.time() - t_start,
           'data_caps': {'voxels': voxels['train'],
                         'lidar_pts': train['points'].shape[1],
                         'mm_pts': train['points_mm'].shape[1]},
           'ok': True,
           'device': torch.cuda.get_device_name(0) if rank_dev != 'cpu'
           else 'cpu',
           'backend': backend,
           'peak_gib': [gib(r['train']['peak_bytes']) for r in results],
           'step_s': [r['train']['seconds'] for r in results],
           'sync_bn_ms': [coll_ms(r, 'moments') for r in results],
           'grad_allreduce_ms': [coll_ms(r, 'grads') for r in results]}
    return rec, {'ranks': results, 'pred_dicts': pred_dicts, 'cfg': cfg,
                 'eval_batch': evaluation}


def one_process_eval(cfg, state_dict, eval_batch, world, device):
    """``eval_batch`` evaluated in this process by the model of
    ``state_dict``, each of ``world`` ranks' shares in one forward as the
    rank evaluates it, merged as ``run_fullwidth`` merges them: the
    prediction dicts. On CUDA the device must be the ranks' (TF32 as
    theirs: off)."""
    import torch
    from ..config import CfgNode
    from ..models.detectors.voxel_rcnn import VoxelRCNN
    from ..utils.jax_weights import load_state_dict_checked
    from ..utils.postprocess import post_process_batch
    from . import data_parallel as dp
    from .. import resolve_device
    dev = resolve_device(device)
    model = VoxelRCNN(cfg.MODEL, cfg.DATA_CONFIG,
                      num_class=len(cfg.CLASS_NAMES))
    load_state_dict_checked(model, state_dict)
    model = model.to(dev).eval()
    outputs = []
    with torch.no_grad():
        for r in range(world):
            share = dp.shard_frames(eval_batch, r, world)
            out = model({k: None if v is None else torch.as_tensor(
                np.ascontiguousarray(v), device=dev)
                for k, v in share.items()})
            outputs.append({k: out[k].cpu() for k in EVAL_KEYS})
    del model
    return post_process_batch(merge_outputs(outputs),
                              CfgNode(cfg.MODEL.POST_PROCESSING),
                              len(cfg.CLASS_NAMES))


def compare_preds(got, want, boxes='pred_boxes', scores='pred_scores'):
    """Two lists of prediction dicts (or KITTI annotations: ``boxes``
    'boxes_lidar', ``scores`` 'score'): the detection counts per frame of
    each, the largest box and score differences over the frames whose
    counts agree (in order), and ``agree``: the same counts on every
    frame, boxes within 5e-3 and scores within 2e-3 (the tolerances of the
    port's distributed evaluation against one process)."""
    same = [(a, b) for a, b in zip(got, want)
            if len(a[scores]) == len(b[scores]) and len(a[scores])]
    out = {
        'detections': [len(p[scores]) for p in got],
        'one_process_detections': [len(p[scores]) for p in want],
        'max_box_diff': max((float(np.abs(a[boxes] - b[boxes]).max())
                             for a, b in same), default=0.0),
        'max_score_diff': max((float(np.abs(a[scores] - b[scores]).max())
                               for a, b in same), default=0.0)}
    out['agree'] = (out['detections'] == out['one_process_detections']
                    and out['max_box_diff'] <= 5e-3
                    and out['max_score_diff'] <= 2e-3)
    return out
