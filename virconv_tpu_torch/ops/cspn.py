"""PENet's DA-CSPN++ propagation: the CUDA kernel wrapper and its plain
PyTorch version (NCHW).

The counterpart of ``cspn_step`` and the propagation loops of
``virconv_tpu/models/depth_completion/penet.py`` (``:233-294``,
``:332-357``). The JAX package has no Pallas kernel here (XLA fuses the
loop); the port's kernel is ``csrc/cspn.cu``, one launch per iteration and
stage for the three kernel sizes together.

``cspn_step`` is the shifted sum in tap order, ``out = out + shift(g_t *
src)`` with ``jnp.roll`` semantics (``out[i] = x[i - shift]``), zero-filled
borders, ``src = h0`` on the centre tap and ``hn`` elsewhere.
``cspn_iteration`` is one iteration of one stage for k = 3, 5, 7, each
followed by the blend ``mask * dsparse + (1 - mask) * d``; at the
half-resolution stage its guides, mask and sparse depth are half-resolution
maps, nearest-upsampled (the plain version materialises the upsample, the
kernel reads at (y >> 1, x >> 1)).
"""

from __future__ import annotations


import torch

KERNEL_SIZES = (3, 5, 7)

# kernel launches (CUDA tensors only), reset and read by chip_smoke.py
launches = 0


def nn_up(x):
    """Nearest 2x upsample of (B, C, H, W) (``jnp.repeat`` twice)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def shift2d(x, dy, dx):
    """(B, C, H, W) shifted by (dy, dx), zero-filled: out[..., i, j] =
    x[..., i - dy, j - dx]."""
    h, w = x.shape[-2:]
    out = torch.zeros_like(x)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    ys, yd = (slice(0, h - dy), slice(dy, h)) if dy >= 0 else \
        (slice(-dy, h), slice(0, h + dy))
    xs, xd = (slice(0, w - dx), slice(dx, w)) if dx >= 0 else \
        (slice(-dx, w), slice(0, w + dx))
    out[..., yd, xd] = x[..., ys, xs]
    return out


def cspn_step(guide, hn, h0, kernel_size, dilation=1):
    """One propagation step (plain): guide (B, k^2, H, W), hn and h0
    (B, 1, H, W); returns (B, 1, H, W)."""
    half = kernel_size // 2
    out = 0.0
    t = 0
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            src = h0 if (dy == 0 and dx == 0) else hn
            out = out + shift2d(guide[:, t:t + 1] * src, dy * dilation,
                                dx * dilation)
            t += 1
    return out


def _check(guides, ds, h0, mask, dsparse, half_res):
    b, _, h, w = h0.shape
    hg, wg = (h // 2, w // 2) if half_res else (h, w)
    if h0.ndim != 4 or h0.shape[1] != 1 or (half_res and (h % 2 or w % 2)):
        raise ValueError(f'cspn: h0 {tuple(h0.shape)}')
    for k, g, d in zip(KERNEL_SIZES, guides, ds):
        if tuple(g.shape) != (b, k * k, hg, wg) or d.shape != h0.shape:
            raise ValueError(f'cspn k={k}: guide {tuple(g.shape)}, depth '
                             f'{tuple(d.shape)} against h0 '
                             f'{tuple(h0.shape)}')
    for name, t in (('mask', mask), ('dsparse', dsparse)):
        if tuple(t.shape) != (b, 1, hg, wg):
            raise ValueError(f'cspn: {name} {tuple(t.shape)}')


def cspn_iteration_plain(guides, ds, h0, mask, dsparse, dilation,
                         half_res):
    """Plain version of one iteration of one stage: ``guides`` (g3, g5,
    g7), ``ds`` the previous (d3, d5, d7). Returns the new (d3, d5, d7)."""
    _check(guides, ds, h0, mask, dsparse, half_res)
    if half_res:
        guides = [nn_up(g) for g in guides]
        mask, dsparse = nn_up(mask), nn_up(dsparse)
    return tuple(mask * dsparse + (1 - mask) * cspn_step(g, d, h0, k,
                                                         dilation)
                 for k, g, d in zip(KERNEL_SIZES, guides, ds))


def cspn_iteration(guides, ds, h0, mask, dsparse, dilation, half_res):
    """One iteration of one stage: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if not h0.is_cuda:
        return cspn_iteration_plain(guides, ds, h0, mask, dsparse, dilation,
                                    half_res)
    _check(guides, ds, h0, mask, dsparse, half_res)
    return _cspn_cuda([g.contiguous() for g in guides],
                      [d.contiguous() for d in ds], h0.contiguous(),
                      mask.contiguous(), dsparse.contiguous(), dilation,
                      half_res)


def _cspn_cuda(guides, ds, h0, mask, dsparse, dilation, half_res):
    """Launch ``cspn_iteration`` (csrc/cspn.cu), the three kernel sizes in
    one launch: a CTA per output tile with the previous depths and their
    halo staged in shared memory (a thread per pixel for dilations PENet
    does not use). The outputs are new tensors, so the caller's loop
    alternates between two sets of buffers of the caching allocator."""
    global launches
    from . import _cuda
    dev = h0.device
    for name, t in (('h0', h0), ('mask', mask), ('dsparse', dsparse),
                    *zip(('g3', 'g5', 'g7'), guides),
                    *zip(('d3', 'd5', 'd7'), ds)):
        _cuda.check_cuda_tensor(t, name, torch.float32, 4, dev)
    b, _, h, w = h0.shape
    outs = [torch.empty_like(h0) for _ in KERNEL_SIZES]
    err = _cuda.load('cspn').cspn_iteration(
        *map(_cuda.ptr, guides), *map(_cuda.ptr, ds), _cuda.ptr(h0),
        _cuda.ptr(mask), _cuda.ptr(dsparse), b, h, w, dilation,
        int(half_res), *map(_cuda.ptr, outs), _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'cspn_iteration launch failed: CUDA error {err}')
    if b:
        launches += 1
    return tuple(outs)
