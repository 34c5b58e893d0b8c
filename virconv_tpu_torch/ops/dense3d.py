"""Dense 3D voxel grids for the coarse backbone scales. Counterpart of
``virconv_tpu/ops/dense3d.py``.

A submanifold sparse conv is a dense conv whose inputs are zero off the
active set and whose outputs are masked back to it; the strided sparse
conv's output-site rule (active iff any active input lies in the window)
is a max-pool of the mask. So ``LidarStack(dense_tail=True)`` runs its
stride-4 and stride-8 scales as dense convs over a (B, D, H, W) occupancy
mask. The JAX package computes them with ``lax.conv`` (XLA, no Pallas
kernel); here they are cuDNN's ``F.conv3d``.

Kernels keep the sparse blocks' (K, C_in, C_out) layout, K enumerated
z-major (``ops.sparse._kernel_offsets``), and are reshaped to
(kz, ky, kx, C_in, C_out) at each call, so one parameter tree drives the
sparse and the dense blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from . import sparse as sp


@dataclasses.dataclass(frozen=True)
class DenseGrid:
    """Dense voxel grid: feats (B, D, H, W, C) zero outside the mask, mask
    (B, D, H, W) bool."""

    feats: torch.Tensor
    mask: torch.Tensor

    @property
    def spatial_shape(self) -> Tuple[int, int, int]:
        return tuple(self.feats.shape[1:4])

    @property
    def batch_size(self) -> int:
        return self.feats.shape[0]

    @property
    def num_channels(self) -> int:
        return self.feats.shape[-1]

    def replace(self, **kw) -> "DenseGrid":
        return dataclasses.replace(self, **kw)


def grid_from_sparse(st: sp.SparseTensor) -> DenseGrid:
    """Write a SparseTensor's valid rows into a DenseGrid."""
    d, h, w = st.spatial_shape
    b = st.batch_size
    size = b * d * h * w
    flat = ((st.coords[:, 0].long() * d + st.coords[:, 1]) * h
            + st.coords[:, 2]) * w + st.coords[:, 3]
    flat = flat[st.mask]
    dev = st.feats.device
    feats = torch.zeros((size, st.num_channels), dtype=st.feats.dtype,
                        device=dev)
    feats[flat] = st.feats[st.mask]
    mask = torch.zeros((size,), dtype=torch.bool, device=dev)
    mask[flat] = True
    return DenseGrid(feats=feats.reshape(b, d, h, w, -1),
                     mask=mask.reshape(b, d, h, w))


def grid_to_sparse(grid: DenseGrid, capacity: int) -> sp.SparseTensor:
    """The grid's active cells as a SparseTensor of ``capacity`` rows in
    (b, z, y, x) scan order (not the key order of ``sparse.key_strides``,
    as in the JAX package); cells past ``capacity`` are dropped in scan
    order."""
    b, d, h, w = grid.mask.shape
    c = grid.num_channels
    dev = grid.feats.device
    src = torch.nonzero(grid.mask.reshape(-1)).squeeze(1)[:capacity]
    n = src.shape[0]
    feats = torch.zeros((capacity, c), dtype=grid.feats.dtype, device=dev)
    feats[:n] = grid.feats.reshape(-1, c)[src]
    cell = d * h * w
    rem = src % cell
    coords = torch.full((capacity, 4), -1, dtype=torch.int32, device=dev)
    coords[:n] = torch.stack([src // cell, rem // (h * w),
                              (rem % (h * w)) // w, rem % w], -1).to(
                                  torch.int32)
    mask = torch.arange(capacity, device=dev) < n
    return sp.SparseTensor(feats=feats, coords=coords, mask=mask,
                           spatial_shape=(d, h, w), batch_size=b)


def _pads(kernel_size, padding):
    """Per-axis pads of ``padding``: 'SAME' (odd kernels) or ints or
    (lo, hi) pairs; the port's blocks pad symmetrically."""
    if padding == 'SAME':
        pads = [((k - 1) // 2, k // 2) for k in kernel_size]
    else:
        pads = [(p, p) if isinstance(p, int) else tuple(p) for p in padding]
    if any(lo != hi for lo, hi in pads):
        raise ValueError(f'asymmetric pads {pads}')
    return tuple(lo for lo, _ in pads)


def dense_conv3d(x, w_gathered, kernel_size, stride=(1, 1, 1),
                 padding='SAME'):
    """(B, D, H, W, C) conv with a gathered-layout (K, C, C') kernel:
    ``F.conv3d`` on the NDHWC tensor seen as channels-last NCDHW. Returns
    (B, D', H', W', C')."""
    kz, ky, kx = kernel_size
    k, c_in, c_out = w_gathered.shape
    if k != kz * ky * kx:
        raise ValueError(f'{k} taps are not a {kernel_size} kernel')
    w = w_gathered.reshape(kz, ky, kx, c_in, c_out).permute(4, 3, 0, 1, 2)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype),
                 stride=tuple(stride), padding=_pads(kernel_size, padding))
    return y.permute(0, 2, 3, 4, 1)


def down_mask(mask, kernel_size, stride, padding):
    """Strided sparse-conv output-site rule: a site is active iff an
    active input lies in its window (a max-pool of the mask)."""
    out = F.max_pool3d(mask[:, None].float(), tuple(kernel_size),
                       tuple(stride), _pads(kernel_size, padding))
    return out[:, 0] > 0


def masked(grid: DenseGrid) -> DenseGrid:
    return grid.replace(feats=torch.where(grid.mask[..., None], grid.feats,
                                          torch.zeros_like(grid.feats)))
