"""Row gather whose backward gives the same bits on every run: the CUDA
kernel wrappers and their plain PyTorch versions.

``gather_rows(feats, idx, valid)`` is ``feats.index_select(0, idx) *
valid`` as an autograd function, as the JAX package's pool gather is.
torch's own backward of ``index_select`` is an ``index_add_``, whose CUDA
kernel adds with atomics in whatever order they land, so a training
step's gradients differed between runs in their last bits. Here the
backward lists each source row's valid gather positions in ascending
order (a CSR: ``csr_of``, a stable sort of ``idx``; on the card
``csrc/gather_rows.cu`` builds it from integer counts, a scan, a scatter
and a sort within each row) and sums them in that order without atomics:
the values of a sequential ``index_add_`` of ``g * valid``, which is the
plain version and what the CPU computes (the invalid positions add zeros,
which the kernels leave out: the pool points every empty slot at one
row). The JAX package's counterpart is
``virconv_tpu/models/roi_heads/voxel_pool.py::gather_rows`` (a
``custom_vjp`` whose backward sorts the indices and segment-sums, in XLA;
no Pallas kernel).

Contract: feats (N, C) f32, idx (M,) integer rows in [0, N), valid (M,)
bool; the forward returns (M, C), the backward dfeats (N, C) = sum over
valid i with idx[i] = r of g[i], in ascending i.
"""

from __future__ import annotations

import torch

# kernel launches (CUDA tensors only), reset and read by chip_smoke.py
launches = 0          # forward gathers
bwd_launches = 0      # backward segment sums


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
    if not feats.is_cuda:
        return gather_rows_plain(feats, idx, valid)
    return _gather_rows_cuda(feats.contiguous(), idx.contiguous(),
                             valid.contiguous())


def _backward(g, idx, valid, n):
    if not g.is_cuda:
        return gather_rows_bwd_plain(g, idx, valid, n)
    return _gather_rows_bwd_cuda(g.contiguous(), idx.contiguous(),
                                 valid.contiguous(), n)


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
    (idx's shape, bool), differentiable in ``feats``: the CUDA kernels for
    CUDA tensors, the plain versions for CPU tensors. Returns
    (idx.numel(), C)."""
    idx = idx.reshape(-1).long()
    valid = valid.reshape(-1).bool()
    _check(feats, idx, valid)
    return _GatherRows.apply(feats, idx, valid)


def _lib():
    from . import _cuda
    return _cuda, _cuda.load('gather_rows')


def _gather_rows_cuda(feats, idx, valid):
    """Launch ``gather_rows_fwd``: a warp per 32 output rows, 16-byte
    vectors when C % 4 == 0 and the tensors are 16-byte aligned."""
    global launches
    _cuda, lib = _lib()
    dev = feats.device
    _cuda.check_cuda_tensor(feats, 'feats', torch.float32, 2)
    _cuda.check_cuda_tensor(idx, 'idx', torch.int64, 1, dev)
    _cuda.check_cuda_tensor(valid, 'valid', torch.bool, 1, dev)
    m, c = idx.shape[0], feats.shape[1]
    out = torch.empty((m, c), dtype=torch.float32, device=dev)
    err = lib.gather_rows_fwd(_cuda.ptr(feats), _cuda.ptr(idx),
                              _cuda.ptr(valid), m, c, _cuda.ptr(out),
                              _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'gather_rows_fwd launch failed: CUDA error {err}')
    if m:
        launches += 1
    return out


def csr_of(idx, valid, n):
    """(order, offsets): the valid positions of ``idx`` sorted by source
    row, ascending within a row (a stable sort; the invalid ones sorted
    past row n - 1), and each row's range of them
    (``offsets[r]:offsets[r + 1]``). The plain version of the CSR the
    backward kernels build."""
    key = torch.where(valid, idx, torch.full_like(idx, n))
    order = torch.sort(key, stable=True).indices
    offsets = torch.zeros((n + 1,), dtype=torch.int64, device=idx.device)
    torch.cumsum(torch.bincount(key, minlength=n + 1)[:n], 0,
                 out=offsets[1:])
    return order, offsets


def _csr_cuda(idx, valid, n):
    """Launch ``gather_rows_csr``: the CSR of the valid positions on int32
    keys in a scratch tensor (a count per row with integer atomics, one
    CTA's scan, a scatter, a sort within each row). Returns the scratch;
    ``csr_views`` reads (order, offsets) from it."""
    _cuda, lib = _lib()
    dev = idx.device
    _cuda.check_cuda_tensor(idx, 'idx', torch.int64, 1)
    _cuda.check_cuda_tensor(valid, 'valid', torch.bool, 1, dev)
    m = idx.shape[0]
    scratch = torch.empty((lib.gather_rows_csr_scratch_bytes(m, n) // 4,),
                          dtype=torch.int32, device=dev)
    err = lib.gather_rows_csr(_cuda.ptr(idx), _cuda.ptr(valid), m, n,
                              _cuda.ptr(scratch), _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'gather_rows_csr failed: CUDA error {err}')
    return scratch


def csr_views(scratch, n):
    """(order, offsets) of a CSR scratch of ``_csr_cuda``, int32: the valid
    positions are ``order[:offsets[n]]``, as ``csr_of``'s first
    ``offsets[n]``."""
    m = (scratch.shape[0] - 3 * n - 2) // 2
    return scratch[3 * n + 2:3 * n + 2 + m], scratch[n:2 * n + 1]


def _rows_sum_cuda(g, scratch, n):
    """Launch ``gather_rows_sum``: each row's gradient rows added in its
    CSR order; a warp per row of at most 256 positions, a CTA per longer
    row streaming them through a shared-memory ring."""
    _cuda, lib = _lib()
    dev = g.device
    dfeats = torch.empty((n, g.shape[1]), dtype=torch.float32, device=dev)
    err = lib.gather_rows_sum(_cuda.ptr(g), _cuda.ptr(scratch), g.shape[0],
                              n, g.shape[1], _cuda.ptr(dfeats),
                              _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'gather_rows_sum failed: CUDA error {err}')
    return dfeats


def _gather_rows_bwd_cuda(g, idx, valid, n):
    """The backward on the card: the CSR (``_csr_cuda``), then the sums in
    its order (``_rows_sum_cuda``)."""
    global bwd_launches
    from . import _cuda
    _cuda.check_cuda_tensor(g, 'g', torch.float32, 2)
    if g.shape[0] != idx.shape[0]:
        raise ValueError(f'gather_rows backward: g {tuple(g.shape)} for '
                         f'{idx.shape[0]} positions')
    if idx.device != g.device:
        raise ValueError(f'gather_rows backward: idx on {idx.device}, g on '
                         f'{g.device}')
    dfeats = _rows_sum_cuda(g, _csr_cuda(idx, valid, n), n)
    if n:
        bwd_launches += 1
    return dfeats
