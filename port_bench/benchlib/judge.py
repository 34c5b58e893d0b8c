"""The comparison that decides ``correct``: the measured side (the
program, or in a control run the reference in a lower precision) against
the plain reference in float32, at the timed sizes.

The reference follows the measured side's discrete selections and the
values that decide them: the RPN's NMS keep indices and its proposals'
values (a direction bin that round-off flips turns a box by pi),
(training) each stage's ROI sample, and the query points of every ROI
grid pool of every stage (whose radius search picks voxels discretely),
so that round-off cannot send the two down different branches; each value
it compares is its own. What it takes over is checked by itself:

- ``nms_miss``: the reference's NMS on the measured side's RPN maps has
  to pick the same anchors (a count; exact);
- ``proposal_gap``: the reference's decoding of the same maps at those
  anchors has to give the measured side's proposals (the largest
  difference, in metres and radians, headings taken modulo 2 pi);
- ``query_gap``: the query points the reference builds itself against
  the measured side's (the largest difference over the valid queries,
  over the largest magnitude); in serving it builds them from the
  proposals at the first stage and from its own decoded boxes at the
  later ones, in training from the sampled ROIs it takes over;
- ``wbf_gap`` (serving): the reference's score threshold and WBF on the
  measured side's ROI predictions have to give its served detections.

Serving numbers (worst over the sampled requests): ``bev_gap`` (BEV
features: voxelize, backbone_3d, bev) and ``rpn_gap`` (the RPN's class,
box and direction maps), each the largest absolute difference over the
reference's largest magnitude, and ``pool_gap`` (the pooled features of
every ROI grid pool call of every stage: K2+K3 or the probe path, and the
features they read), the same; ``head_gap_s<i>`` (the class and box
residual outputs of stage i of the ROI head), the norm of the difference
over the reference's norm, and ``head_gap`` their worst; ``roi_gap`` (the
ROI head's scores and boxes, averaged over the stages, that the served
detections are made from), the same, since the largest difference of one
ROI swings from seed to seed. A cell's limits file names the numbers it
holds (see PERF.md). Training numbers (the first three steps):
``loss_gap`` (the first step's loss, relative: the later steps' swing,
see PERF.md), ``grad_gap`` (the first step's gradient) and ``delta_gap``
(the parameters' change over three steps), by the worst leaf: the gap
between the two norms over the larger of the reference's norm of that
leaf and of the median leaf; ``grad_gap_median``, the same gap of the
median leaf. Leaves whose first reference gradient is
under a thousandth of the median leaf's take no part.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

MISMATCH = 1.0e6     # a count or label that differs: no gap can say less


@contextlib.contextmanager
def following(model, item, own=None):
    """Inside the block ``model`` takes ``item``'s (a capture's) NMS
    selection and proposals, ROI samples (training) and pool query
    points; ``own`` (a list) receives its own query points
    (``capture.follow_pools``)."""
    from .capture import follow_pools
    model.dense_head.follow_keep = [(item['keep'], item['keep_valid'],
                                     item['rois'])]
    if 'sampled' in item:
        model.roi_head.follow_sampled = list(item['sampled'])
    handles = follow_pools(model, item['pool_q'], own)
    try:
        yield
    finally:
        model.dense_head.follow_keep = None
        model.roi_head.follow_sampled = None
        for h in handles:
            h.remove()


def relgap(a, b):
    a, b = a.detach().float(), b.detach().float()
    if a.shape != b.shape:
        return MISMATCH
    scale = b.abs().max().clamp(min=1e-12)
    return float((a - b).abs().max() / scale)


def query_gap(own):
    """Largest difference between the model's own query points and the
    ones it took over, over their valid queries, relative to the largest
    magnitude of the latter."""
    worst = 0.0
    for mine, theirs, mask in own:
        if not bool(mask.any()):
            continue
        a, b = mine[mask].float(), theirs[mask].float()
        scale = b.abs().max().clamp(min=1e-12)
        worst = max(worst, float((a - b).abs().max() / scale))
    return worst


def stage_gaps(item, mine):
    """``head_gap_s<i>`` per stage of the ROI head, and ``head_gap``."""
    n = len(mine['stage_cls'])
    if len(item['stage_cls']) != n or len(item['stage_reg']) != n:
        return {'head_gap': MISMATCH}
    out = {f'head_gap_s{i + 1}': max(rel_l2(c1, c2), rel_l2(r1, r2))
           for i, (c1, c2, r1, r2) in enumerate(zip(
               item['stage_cls'], mine['stage_cls'], item['stage_reg'],
               mine['stage_reg']))}
    out['head_gap'] = max(out.values())
    return out


def same_batch(item, batch):
    """Whether the measured side's capture is of this batch's frames: its
    proposals cover as many frames."""
    points = batch['points']
    tp = batch.get('transform_param')
    n_rep = tp.shape[1] if tp is not None else 1
    return item['keep'].shape[0] == points.shape[0] // n_rep


def rel_l2(a, b):
    """‖a - b‖ / ‖b‖ over all elements."""
    a, b = a.detach().float(), b.detach().float()
    if a.shape != b.shape:
        return MISMATCH
    return float((a - b).norm() / b.norm().clamp(min=1e-12))


def anchor_points(batch):
    """The RPN anchor mask's points: replica 0 of each frame, as the
    detector takes them."""
    points = batch['points']
    tp = batch.get('transform_param')
    n_rep = tp.shape[1] if tp is not None else 1
    b = points.shape[0] // n_rep
    pts0 = points.reshape(b, n_rep, *points.shape[1:])[:, 0]
    pv0 = batch['points_valid'].reshape(b, n_rep, -1)[:, 0]
    return pts0[..., 0:2].reshape(-1, 2), pv0.reshape(-1)


def nms_on(model, item, batch, mode):
    """The reference's RPN decode and NMS on the measured side's maps:
    its proposals (``rois``, ``keep``, ``roi_valid``)."""
    head = model.dense_head
    maps = {head.conv_cls: item['cls_map'], head.conv_box: item['box_map'],
            head.conv_dir: item['dir_map']}
    handles = [m.register_forward_hook(lambda m_, i_, o_, v=v: v)
               for m, v in maps.items()]
    was = head.training
    head.eval()
    try:
        shape = item['cls_map'].shape
        bev = torch.zeros((shape[0], shape[2], shape[3],
                           head.conv_cls.in_channels),
                          device=item['cls_map'].device)
        pts, pv = anchor_points(batch)
        with torch.no_grad():
            out = head(bev, pts, pv, model.nms_cfg[mode])
    finally:
        head.train(was)
        for h in handles:
            h.remove()
    return out


def box_gap(a, b):
    """Largest difference between boxes (..., 7+): metres, and radians
    modulo 2 pi."""
    a = a[..., :7].detach().reshape(-1, 7).float()
    b = b[..., :7].detach().reshape(-1, 7).float()
    if a.shape != b.shape:
        return MISMATCH
    if not a.shape[0]:
        return 0.0
    d = (a - b).abs()
    d[:, 6] = (torch.remainder(a[:, 6] - b[:, 6] + math.pi, 2 * math.pi)
               - math.pi).abs()
    return float(d.max())


def selection_gaps(model, item, batch, mode):
    """``nms_miss`` (anchors picked on one side only) and
    ``proposal_gap`` (the largest difference of the proposals both picked:
    metres, and radians modulo 2 pi)."""
    out = nms_on(model, item, batch, mode)
    keep, valid = out['keep'], out['roi_valid']
    if keep.shape != item['keep'].shape:
        return {'nms_miss': MISMATCH, 'proposal_gap': MISMATCH}
    differ = (valid != item['keep_valid']) | (
        valid & (keep != item['keep']))
    both = valid & ~differ
    return {'nms_miss': float(differ.sum()),
            'proposal_gap': box_gap(item['rois'][both], out['rois'][both])}


def wbf_gap(served, redone):
    """Largest difference between two lists of per-frame detections; a
    count or label that differs gives MISMATCH."""
    worst = 0.0
    if len(served) != len(redone):
        return MISMATCH
    for a, b in zip(served, redone):
        if len(a['scores']) != len(b['scores']) or \
                not np.array_equal(a['labels'], b['labels']):
            return MISMATCH
        if len(a['scores']):
            worst = max(worst, float(np.abs(a['boxes'] - b['boxes']).max()),
                        float(np.abs(a['scores'] - b['scores']).max()))
    return worst


SERVING = ('bev_gap', 'rpn_gap', 'pool_gap', 'head_gap', 'roi_gap',
           'nms_miss', 'proposal_gap', 'query_gap', 'wbf_gap')


def judge_request(ref, frames, item, served):
    """The serving numbers of one request: ``ref`` a RefDetector (f32),
    ``item`` the measured side's capture, ``served`` its detections."""
    from .capture import Capture
    if not same_batch(item, ref.make_batch(frames)):
        return dict.fromkeys(SERVING, MISMATCH)
    cap = Capture(ref.model)
    cap.armed = True
    own = []
    try:
        with following(ref.model, item, own):
            ref.forward(frames)
    finally:
        cap.remove()
    mine = cap.items[0]
    batch = ref.make_batch(frames)
    redone = ref.postprocess({'batch_cls_preds': item['cls'],
                              'batch_box_preds': item['box'],
                              'roi_valid': item['roi_valid']})
    pooled = list(zip(item['pooled'], mine['pooled']))
    out = {
        'bev_gap': relgap(item['bev'], mine['bev']),
        'rpn_gap': max(relgap(item[k], mine[k])
                       for k in ('cls_map', 'box_map', 'dir_map')),
        'pool_gap': max(relgap(a, b) for a, b in pooled)
        if len(item['pooled']) == len(mine['pooled']) else MISMATCH,
        'roi_gap': max(rel_l2(item['cls'], mine['cls']),
                       rel_l2(item['box'], mine['box'])),
        'query_gap': query_gap(own),
        'wbf_gap': wbf_gap(served, redone)}
    out.update(stage_gaps(item, mine))
    out.update(selection_gaps(ref.model, item, batch, 'test'))
    return out


def leaf_norms(tensors):
    return {k: float(v.detach().float().norm()) for k, v in tensors.items()}


def leaf_gaps(mine, ref, leaves):
    """Per leaf of ``leaves``: |‖mine‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    nm, nr = leaf_norms({k: mine[k] for k in leaves}), \
        leaf_norms({k: ref[k] for k in leaves})
    med = float(np.median([nr[k] for k in leaves]))
    return {k: abs(nm[k] - nr[k]) / max(nr[k], med, 1e-30) for k in leaves}


def worst_leaf(mine, ref, leaves):
    return max(leaf_gaps(mine, ref, leaves).values())


TRAINING = ('loss_gap', 'grad_gap', 'grad_gap_median', 'delta_gap',
            'nms_miss', 'proposal_gap', 'query_gap')


def judge_steps(ref_trainer, batches, side):
    """The training numbers: ``side`` holds the measured side's
    ``losses`` (3), ``grads`` (leaf -> first step's gradient), ``p0`` and
    ``p3`` (parameters before and after three steps) and ``items`` (its
    captures of the three steps)."""
    model = ref_trainer.model
    losses, grads = [], None
    stages = {}
    for t, batch in enumerate(batches):
        item = side['items'][t]
        dev_batch = ref_trainer.to_device(batch)
        if not same_batch(item, dev_batch):
            return dict.fromkeys(TRAINING, MISMATCH), {
                'losses': [], 'loss_gaps': [], 'leaves_compared': 0,
                'leaves': 0}
        for k, v in selection_gaps(model, item, dev_batch, 'train').items():
            stages[k] = max(stages.get(k, 0.0), v)
        own = []
        with following(model, item, own):
            losses.append(float(ref_trainer.step(batch)))
        stages['query_gap'] = max(stages.get('query_gap', 0.0),
                                  query_gap(own))
        if t == 0:
            grads = {n: (p.grad if p.grad is not None
                         else torch.zeros_like(p)).detach().clone()
                     for n, p in model.named_parameters()}
    p3 = {n: p.detach() for n, p in model.named_parameters()}
    gn = leaf_norms(grads)
    med = float(np.median(list(gn.values())))
    leaves = [k for k, v in gn.items() if v >= 1e-3 * med]
    d_mine = {k: side['p3'][k] - side['p0'][k] for k in leaves}
    d_ref = {k: p3[k] - side['p0'][k] for k in leaves}
    gaps = [abs(a - b) / max(abs(b), 1e-12)
            for a, b in zip(side['losses'], losses)]
    g = leaf_gaps(side['grads'], grads, leaves)
    worst = sorted(g, key=g.get, reverse=True)[:3]
    return {
        'loss_gap': gaps[0],
        'grad_gap': max(g.values()),
        'grad_gap_median': float(np.median(list(g.values()))),
        'delta_gap': worst_leaf(d_mine, d_ref, leaves),
        **stages}, {'losses': losses, 'loss_gaps': gaps,
                    'leaves_compared': len(leaves), 'leaves': len(gn),
                    'grad_worst': [[k, g[k], gn[k] / med] for k in worst]}
