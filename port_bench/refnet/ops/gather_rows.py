"""Row gather ``feats.index_select(0, idx) * valid`` as an autograd
function, in plain PyTorch (frozen copy of the measured program's plain
versions; no kernel). Backward: an ``index_add_`` of ``g * valid``.
"""

from __future__ import annotations

import torch

from .. import tally


def gather_rows_plain(feats, idx, valid):
    """Plain forward: ``index_select`` times ``valid``."""
    return feats.index_select(0, idx) * valid[:, None].to(feats.dtype)


def gather_rows_bwd_plain(g, idx, valid, n):
    """Plain backward: ``index_add_`` of ``g * valid`` into zeros (in
    index order on the CPU)."""
    return g.new_zeros((n, g.shape[1])).index_add_(
        0, idx, g * valid[:, None].to(g.dtype))


def _check(feats, idx, valid):
    if feats.ndim != 2 or idx.ndim != 1 or valid.shape != idx.shape:
        raise ValueError(f'gather_rows: feats {tuple(feats.shape)}, idx '
                         f'{tuple(idx.shape)}, valid {tuple(valid.shape)}: '
                         'expected (N, C), (M,) and (M,)')


def _forward(feats, idx, valid):
    return gather_rows_plain(feats, idx, valid)


def _backward(g, idx, valid, n):
    return gather_rows_bwd_plain(g, idx, valid, n)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, idx, valid):
        ctx.save_for_backward(idx, valid)
        ctx.n = feats.shape[0]
        return _forward(feats, idx, valid)

    @staticmethod
    def backward(ctx, g):
        idx, valid = ctx.saved_tensors
        dfeats = _backward(g, idx, valid, ctx.n) \
            if ctx.needs_input_grad[0] else None
        return dfeats, None, None


def gather_rows(feats, idx, valid):
    """``feats`` rows at ``idx`` (any shape; flattened) times ``valid``
    (idx's shape, bool), differentiable in ``feats``. Returns
    (idx.numel(), C)."""
    idx = idx.reshape(-1).long()
    valid = valid.reshape(-1).bool()
    _check(feats, idx, valid)
    tally.gather(feats.shape[0], valid, feats.shape[1])
    return _GatherRows.apply(feats, idx, valid)
