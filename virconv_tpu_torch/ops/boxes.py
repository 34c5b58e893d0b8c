"""Box geometry on tensors: rotated BEV overlap by Green's theorem, 3D IoU,
greedy rotated NMS, the residual box coder and the box losses of training
(corner loss, bb loss). Counterpart of ``virconv_tpu/ops/boxes.py``; boxes
are (x, y, z, dx, dy, dz, heading) in the LiDAR frame. All products are
elementwise f32 (no matmuls), which keeps the parallel-edge tests of the
overlap exact on every device. Everything is differentiable where the JAX
version is (training backpropagates through the proposals). The RPN's NMS
over a forward's entries runs on the kernel pair of ``csrc/nms.cu`` for
CUDA tensors (``nms_bev_batched``)."""

from __future__ import annotations

import collections
import math

import torch

EPS = 1e-8
NMS_MAX_K = 65536          # csrc/nms.cu's kNmsMaxK: the keep bits it holds

# nms_bev_batched: the kernel pair's launches (CUDA tensors only), and the
# entries it ran on the kernels ('kernel') or on the plain loop ('plain');
# reset and read by chip_smoke.py and the tests
nms_launches = 0
nms_counts = collections.Counter()


def clip(x, lo=None, hi=None):
    """``jnp.clip``: a maximum, then a minimum, so a value at a bound
    passes half its gradient, as JAX's does (``torch.clamp`` passes all of
    it). Where the box overlap meets its bounds exactly (touching or
    parallel edges), its gradients then agree with the JAX package's.
    Without a gradient to take (evaluation, NMS) it is ``torch.clamp``:
    the same values in one launch."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.clamp(x, lo, hi)
    if lo is not None:
        x = torch.maximum(x, torch.full_like(x, lo))
    if hi is not None:
        x = torch.minimum(x, torch.full_like(x, hi))
    return x


def limit_period(val, offset=0.5, period=math.pi):
    return val - torch.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """Rotate (B, N, 3+C) points by (B,) angles around +z, as elementwise
    products summed in index order."""
    cosa = torch.cos(angle)[:, None]
    sina = torch.sin(angle)[:, None]
    x, y = points[..., 0], points[..., 1]
    zero = torch.zeros_like(x)
    xr = x * cosa + y * (-sina) + zero
    yr = x * sina + y * cosa + zero
    return torch.cat([torch.stack([xr, yr, points[..., 2]], -1),
                      points[..., 3:]], -1)


def boxes_to_corners_bev(boxes):
    """BEV corners (N, 4, 2), counter-clockwise."""
    template = torch.tensor([[0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5],
                             [0.5, -0.5]], dtype=boxes.dtype,
                            device=boxes.device)
    corners = template[None] * torch.stack([boxes[:, 3], boxes[:, 4]],
                                           -1)[:, None, :]
    cosa = torch.cos(boxes[:, 6])[:, None]
    sina = torch.sin(boxes[:, 6])[:, None]
    x = corners[..., 0] * cosa - corners[..., 1] * sina
    y = corners[..., 0] * sina + corners[..., 1] * cosa
    return torch.stack([x, y], -1) + boxes[:, None, 0:2]


def boxes_to_corners_3d(boxes):
    """All 8 corners (N, 8, 3), in the reference box_utils order."""
    template = torch.tensor([
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
    ], dtype=boxes.dtype, device=boxes.device) / 2.0
    corners = boxes[:, None, 3:6] * template[None]
    corners = rotate_points_along_z(corners, boxes[:, 6])
    return corners + boxes[:, None, 0:3]


def _rect_halfplanes(boxes):
    """Half-plane form: normals (N, 4, 2), offsets (N, 4); inside is
    n . x <= c."""
    cosa, sina = torch.cos(boxes[:, 6]), torch.sin(boxes[:, 6])
    n1 = torch.stack([cosa, sina], -1)
    n2 = torch.stack([-sina, cosa], -1)
    normals = torch.stack([n1, -n1, n2, -n2], 1)
    proj = (normals * boxes[:, None, 0:2]).sum(-1)
    half = torch.stack([boxes[:, 3] / 2, boxes[:, 3] / 2,
                        boxes[:, 4] / 2, boxes[:, 4] / 2], -1)
    return normals, proj + half


def _clipped_edge_integrals(corners, normals, offsets, coincide_tol=1e-4):
    """Green's-theorem contribution of one box's edges clipped to another
    box's half-planes (Liang-Barsky); edges on a clip boundary weigh 1/2."""
    u = corners
    d = torch.roll(corners, -1, dims=-2) - u
    npl = normals[..., None, :, :]
    nu = (npl * u[..., :, None, :]).sum(-1)
    nd = (npl * d[..., :, None, :]).sum(-1)
    c = offsets[..., None, :]
    par_eps = 1e-4
    denom = torch.where(nd.abs() < par_eps, torch.full_like(nd, par_eps), nd)
    t_hit = (c - nu) / denom
    t_lo = torch.where(nd < -par_eps, t_hit, torch.zeros_like(t_hit)).amax(-1)
    t_hi = torch.where(nd > par_eps, t_hit, torch.ones_like(t_hit)).amin(-1)
    parallel = nd.abs() <= par_eps
    infeasible = (parallel & (nu > c + coincide_tol)).any(-1)
    on_boundary = (parallel & ((nu - c).abs() <= coincide_tol)).any(-1)
    t0 = clip(t_lo, 0.0, 1.0)
    t1 = clip(t_hi, 0.0, 1.0)
    ok = (~infeasible) & (t1 > t0)
    p0 = u + t0[..., None] * d
    p1 = u + t1[..., None] * d
    cross = p0[..., 0] * p1[..., 1] - p1[..., 0] * p0[..., 1]
    weight = torch.where(on_boundary, 0.5, 1.0).to(cross.dtype)
    return (torch.where(ok, cross, torch.zeros_like(cross)) * weight).sum(-1)


def boxes_overlap_bev(boxes_a, boxes_b, row_chunk: int | None = None):
    """Pairwise rotated BEV overlap areas (N, M)."""
    ca = boxes_to_corners_bev(boxes_a)
    cb = boxes_to_corners_bev(boxes_b)
    na, oa = _rect_halfplanes(boxes_a)
    nb, ob = _rect_halfplanes(boxes_b)

    def block(ca_, na_, oa_):
        suma = _clipped_edge_integrals(ca_[:, None], nb[None], ob[None])
        sumb = _clipped_edge_integrals(cb[None], na_[:, None], oa_[:, None])
        return clip(0.5 * (suma + sumb), 0.0)

    n = boxes_a.shape[0]
    if row_chunk is None or n <= row_chunk:
        return block(ca, na, oa)
    return torch.cat([block(ca[i:i + row_chunk], na[i:i + row_chunk],
                            oa[i:i + row_chunk])
                      for i in range(0, n, row_chunk)])


def boxes_overlap_bev_pairs(boxes_a, boxes_b):
    """Rotated BEV overlap area of each pair (boxes_a[i], boxes_b[i]): (N,),
    the diagonal of ``boxes_overlap_bev`` (the JAX package's per-pair
    ``vmap`` of it) without the N x N work."""
    na, oa = _rect_halfplanes(boxes_a)
    nb, ob = _rect_halfplanes(boxes_b)
    suma = _clipped_edge_integrals(boxes_to_corners_bev(boxes_a), nb, ob)
    sumb = _clipped_edge_integrals(boxes_to_corners_bev(boxes_b), na, oa)
    return clip(0.5 * (suma + sumb), 0.0)


def points_in_boxes(points, boxes):
    """(P,) int32 index of the first (N, 7) box containing each of the
    (P, 3+) points, -1 if none: the dense rotate + axis-aligned test of
    ``virconv_tpu.ops.boxes.points_in_boxes``, on the caller's device
    (the host copies are ``ops/boxes_np.py`` and ``ops/native.py``)."""
    d = points[:, None, 0:3] - boxes[None, :, 0:3]          # (P, N, 3)
    cosa = torch.cos(boxes[:, 6])[None]
    sina = torch.sin(boxes[:, 6])[None]
    lx = d[..., 0] * cosa + d[..., 1] * sina
    ly = -d[..., 0] * sina + d[..., 1] * cosa
    inside = ((lx.abs() <= boxes[None, :, 3] / 2)
              & (ly.abs() <= boxes[None, :, 4] / 2)
              & (d[..., 2].abs() <= boxes[None, :, 5] / 2))
    if inside.shape[1] == 0:
        return torch.full((points.shape[0],), -1, dtype=torch.int32,
                          device=points.device)
    idx = torch.argmax(inside.to(torch.uint8), 1).to(torch.int32)
    return torch.where(inside.any(1), idx, torch.full_like(idx, -1))


def boxes_iou_bev(boxes_a, boxes_b, row_chunk: int | None = None):
    inter = boxes_overlap_bev(boxes_a, boxes_b, row_chunk=row_chunk)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=EPS)


def boxes_iou3d(boxes_a, boxes_b):
    """Pairwise 3D IoU (N, M): BEV overlap x z overlap / union."""
    inter_bev = boxes_overlap_bev(boxes_a, boxes_b)
    za1 = boxes_a[:, 2] - boxes_a[:, 5] / 2
    za2 = boxes_a[:, 2] + boxes_a[:, 5] / 2
    zb1 = boxes_b[:, 2] - boxes_b[:, 5] / 2
    zb2 = boxes_b[:, 2] + boxes_b[:, 5] / 2
    zi = torch.clamp(torch.minimum(za2[:, None], zb2[None])
                     - torch.maximum(za1[:, None], zb1[None]), min=0.0)
    inter = inter_bev * zi
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None]
    return inter / torch.clamp(vol_a + vol_b - inter, min=EPS)


def nms_bev(boxes, scores, thresh: float, pre_max: int, post_max: int,
            valid=None, num_iters: int = 8):
    """Rotated NMS by fixed-point suppression (``virconv_tpu.ops.boxes.
    nms_bev``) of one entry: ``nms_bev_plain`` at B = 1, on any device. The
    top ``pre_max`` by score come from a stable descending sort, so ties
    keep the lower index first as XLA's top_k does.

    Returns (selected indices (post_max,) into the input, valid mask)."""
    sel, sel_valid = nms_bev_plain(boxes[None], scores[None], thresh,
                                   pre_max, post_max, valid, num_iters)
    return sel[0], sel_valid[0]


def nms_bev_batched(boxes, scores, thresh: float, pre_max: int,
                    post_max: int, valid=None, num_iters: int = 8):
    """``nms_bev`` of each of B entries: boxes (B, n, 7), scores (B, n) and
    one (n,) valid mask for all of them. Returns (sel, sel_valid), each
    (B, post_max), row b ``nms_bev``'s of entry b. CUDA tensors run the
    kernel pair of ``csrc/nms.cu`` for all entries (two launches, no host
    sync) or raise; CPU tensors ``nms_bev_plain``."""
    b = boxes.shape[0]
    if not boxes.is_cuda:
        nms_counts['plain'] += b
        return nms_bev_plain(boxes, scores, thresh, pre_max, post_max, valid,
                             num_iters)
    nms_counts['kernel'] += b
    order, top_valid, top = nms_top_k(boxes, scores, pre_max, valid)
    mask, _ = _nms_mask_cuda(top, top_valid, thresh)
    return _nms_select_cuda(mask, top_valid, order, post_max, num_iters)


def nms_bev_plain(boxes, scores, thresh: float, pre_max: int, post_max: int,
                  valid=None, num_iters: int = 8):
    """The plain composition of ``nms_bev_batched`` (the same arguments and
    results): the batched top-k, each entry's suppression, then the fixed
    point and the compaction of all entries at once."""
    order, top_valid, top = nms_top_k(boxes, scores, pre_max, valid)
    return nms_select_plain(nms_sup_plain(top, top_valid, thresh), top_valid,
                            order, post_max, num_iters)


def nms_top_k(boxes, scores, pre_max: int, valid=None):
    """``nms_bev``'s top ``pre_max`` of B entries at once, by one stable
    descending sort of the (B, n) masked scores: order (B, k) into the
    input, top_valid (B, k) (a finite score) and the boxes (B, k, 7)."""
    b, n = scores.shape
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=scores.device)
    masked = torch.where(valid, scores,
                         torch.full_like(scores, -float('inf')))
    k = min(pre_max, n)
    top_scores, order = torch.sort(masked, dim=-1, descending=True,
                                   stable=True)
    top_scores, order = top_scores[:, :k], order[:, :k]
    top = torch.gather(boxes[..., :7], 1, order[..., None].expand(b, k, 7))
    return order, torch.isfinite(top_scores), top


def nms_sup_plain(top, top_valid, thresh: float):
    """Plain version of ``nms_overlap_mask`` (csrc/nms.cu), unpacked:
    ``nms_bev``'s suppression (B, k, k) of each entry's top-k boxes (B, k,
    7), ``(iou > thresh) & valid_i & valid_j`` for j < i."""
    k = top.shape[1]
    tri = torch.tril(torch.ones((k, k), dtype=torch.bool, device=top.device),
                     diagonal=-1)
    return torch.stack([
        (boxes_iou_bev(t, t, row_chunk=256 if k > 512 else None) > thresh)
        & v[:, None] & v[None, :] & tri for t, v in zip(top, top_valid)])


def nms_select_plain(sup, top_valid, order, post_max: int,
                     num_iters: int = 8):
    """Plain version of ``nms_select`` (csrc/nms.cu): ``nms_bev``'s fixed
    point on each entry's suppression ``sup`` (B, k, k), then the kept
    proposals' input indices (``order`` (B, k)) compacted by a scatter into
    post_max + 1 slots, the last taking those past post_max: no
    boolean-mask index, so no host sync. Returns (sel, sel_valid)."""
    b, k = top_valid.shape
    keep = torch.ones_like(top_valid)
    for _ in range(num_iters):
        keep = ~(sup & keep[:, None, :]).any(2) & top_valid
    rank = torch.cumsum(keep.to(torch.int64), 1) - 1
    slot = torch.where(keep & (rank < post_max), rank,
                       torch.full_like(rank, post_max))
    sel = torch.zeros((b, post_max + 1), dtype=torch.long,
                      device=order.device).scatter_(1, slot, order)
    count = torch.clamp(keep.sum(1, keepdim=True), max=post_max)
    sel_valid = torch.arange(post_max, device=order.device) < count
    sel = sel[:, :post_max]
    return torch.where(sel_valid, sel, torch.zeros_like(sel)), sel_valid


def nms_mask_bits(mask, k: int):
    """The (B, k, k) bool of ``nms_overlap_mask``'s words (B, k, ceil(k /
    64)): bit j % 64 of word j // 64 of row i for j < i (the kernel writes
    no word past a row's diagonal word)."""
    j = torch.arange(k, device=mask.device)
    return ((mask[..., j // 64] >> (j % 64)) & 1).bool() & (j[None, :, None]
                                                          > j[None, None])


def nms_geometry(top):
    """``nms_overlap_mask``'s operands for boxes (B, k, 7): the corners,
    half-plane normals and offsets and the areas of the B * k boxes, from
    the plain version's functions, so their bits are its bits."""
    flat = top.reshape(-1, 7)
    normals, offsets = _rect_halfplanes(flat)
    return (boxes_to_corners_bev(flat).contiguous(), normals, offsets,
            flat[:, 3] * flat[:, 4])


def _nms_mask_cuda(top, top_valid, thresh: float, iou: bool = False):
    """Launch ``nms_overlap_mask`` on every entry's top-k boxes (B, k, 7)
    and valid flags (B, k): the (B, k, ceil(k / 64)) int64 words of the
    suppression's strict lower triangle. With ``iou`` (tests) the kernel
    also writes the float IoU of each pair j < i, 0 elsewhere; returns
    (words, IoU or None)."""
    global nms_launches
    from . import _cuda
    dev = top.device
    b, k = top_valid.shape
    if k > NMS_MAX_K:
        raise ValueError(f'nms: k = {k} past NMS_MAX_K = {NMS_MAX_K}')
    geometry = (*nms_geometry(top), top_valid.contiguous())
    for name, t in zip(('corners', 'normals', 'offsets', 'area', 'valid'),
                       geometry):
        _cuda.check_cuda_tensor(t, name, torch.bool if name == 'valid'
                                else torch.float32, device=dev)
    mask = torch.empty((b, k, -(-k // 64)), dtype=torch.int64, device=dev)
    args = [*map(_cuda.ptr, geometry), b, k, float(thresh), _cuda.ptr(mask)]
    lib = _cuda.load('nms')
    out = None
    if iou:
        out = torch.zeros((b, k, k), dtype=torch.float32, device=dev)
        err = lib.nms_overlap_iou(*args, _cuda.ptr(out), _cuda.stream_ptr(dev))
    else:
        err = lib.nms_overlap_mask(*args, _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'nms_overlap_mask launch failed: CUDA error {err}')
    if b and k:
        nms_launches += 1
    return mask, out


def _nms_select_cuda(mask, top_valid, order, post_max: int, num_iters: int):
    """Launch ``nms_select``: each entry's fixed point on the words of
    ``_nms_mask_cuda`` and its kept proposals' input indices, (sel,
    sel_valid) (B, post_max) as ``nms_select_plain`` gives them."""
    global nms_launches
    from . import _cuda
    dev = mask.device
    b, k = top_valid.shape
    order, top_valid = order.contiguous(), top_valid.contiguous()
    for name, t, dt in (('mask', mask, torch.int64),
                        ('valid', top_valid, torch.bool),
                        ('order', order, torch.int64)):
        _cuda.check_cuda_tensor(t, name, dt, device=dev)
    sel = torch.empty((b, post_max), dtype=torch.long, device=dev)
    sel_valid = torch.empty((b, post_max), dtype=torch.bool, device=dev)
    err = _cuda.load('nms').nms_select(
        *map(_cuda.ptr, (mask, top_valid, order)), b, k, post_max,
        num_iters, _cuda.ptr(sel), _cuda.ptr(sel_valid),
        _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'nms_select launch failed: CUDA error {err}')
    if b and post_max:
        nms_launches += 1
    return sel, sel_valid


class ResidualCoder:
    """Anchor-residual box coder (with the JAX package's symmetric log-dim
    clamp at +-10 in the decoder)."""

    def __init__(self, code_size=7):
        self.code_size = code_size

    def encode(self, boxes, anchors):
        anchors = torch.cat([anchors[..., :3],
                             torch.clamp(anchors[..., 3:6], min=1e-5),
                             anchors[..., 6:]], -1)
        boxes = torch.cat([boxes[..., :3],
                           torch.clamp(boxes[..., 3:6], min=1e-5),
                           boxes[..., 6:]], -1)
        xa, ya, za, dxa, dya, dza, ra = torch.split(anchors[..., :7], 1, -1)
        xg, yg, zg, dxg, dyg, dzg, rg = torch.split(boxes[..., :7], 1, -1)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        cts = [boxes[..., 7 + i:8 + i] - anchors[..., 7 + i:8 + i]
               for i in range(boxes.shape[-1] - 7)]
        return torch.cat([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
                          torch.log(dxg / dxa), torch.log(dyg / dya),
                          torch.log(dzg / dza), rg - ra, *cts], -1)

    def decode(self, encodings, anchors):
        xa, ya, za, dxa, dya, dza, ra = torch.split(anchors[..., :7], 1, -1)
        xt, yt, zt, dxt, dyt, dzt, rt = torch.split(encodings[..., :7], 1, -1)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        xg = xt * diag + xa
        yg = yt * diag + ya
        zg = zt * dza + za
        dxg = torch.exp(torch.clamp(dxt, -10.0, 10.0)) * dxa
        dyg = torch.exp(torch.clamp(dyt, -10.0, 10.0)) * dya
        dzg = torch.exp(torch.clamp(dzt, -10.0, 10.0)) * dza
        rg = rt + ra
        rest = encodings.shape[-1] - self.code_size
        cgs = [encodings[..., self.code_size + i:self.code_size + i + 1]
               + anchors[..., 7 + i:8 + i] for i in range(rest)]
        return torch.cat([xg, yg, zg, dxg, dyg, dzg, rg, *cgs], -1)


def corner_loss(pred_boxes, gt_boxes):
    """Per-box Huber (delta 1) of the corner distances to the gt box or its
    heading-flipped twin, whichever is nearer, averaged over corners."""
    pred_c = boxes_to_corners_3d(pred_boxes)
    gt_c = boxes_to_corners_3d(gt_boxes)
    gt_flip = torch.cat([gt_boxes[:, :6], gt_boxes[:, 6:7] + math.pi,
                         gt_boxes[:, 7:]], -1)
    gt_cf = boxes_to_corners_3d(gt_flip)
    d = torch.minimum(torch.linalg.norm(pred_c - gt_c, dim=-1),
                      torch.linalg.norm(pred_c - gt_cf, dim=-1))
    abs_d = d.abs()
    loss = torch.where(abs_d < 1.0, 0.5 * d ** 2, abs_d - 0.5)
    return loss.mean(1)


def _axis_overlap_ratio(c1, w1, c2, w2):
    """1D overlap / total span of two centered intervals."""
    hi = torch.minimum(c1 + w1 / 2, c2 + w2 / 2)
    lo = torch.maximum(c1 - w1 / 2, c2 - w2 / 2)
    span_hi = torch.maximum(c1 + w1 / 2, c2 + w2 / 2)
    span_lo = torch.minimum(c1 - w1 / 2, c2 - w2 / 2)
    return torch.clamp(hi - lo, min=0.0) / torch.clamp(span_hi - span_lo,
                                                       min=EPS)


def bb_loss(pred_boxes, gt_boxes):
    """Per-box loss of the rcnn reg branch: 1 - (product of per-axis overlap
    ratios x (1 - |sin dr|)) + 1.25 (1 - |cos dr|) + squared center
    distance, all x 1.5."""
    iou = (_axis_overlap_ratio(pred_boxes[:, 0], pred_boxes[:, 3],
                               gt_boxes[:, 0], gt_boxes[:, 3])
           * _axis_overlap_ratio(pred_boxes[:, 1], pred_boxes[:, 4],
                                 gt_boxes[:, 1], gt_boxes[:, 4])
           * _axis_overlap_ratio(pred_boxes[:, 2], pred_boxes[:, 5],
                                 gt_boxes[:, 2], gt_boxes[:, 5]))
    dr = pred_boxes[:, 6] - gt_boxes[:, 6]
    iou = iou * (1.0 - torch.sin(dr).abs())
    angle_factor = 1.25 * (1.0 - torch.cos(dr).abs())
    center_sq = ((gt_boxes[:, 0:3] - pred_boxes[:, 0:3]) ** 2).sum(-1)
    return (1.0 - iou + angle_factor + center_sq) * 1.5
