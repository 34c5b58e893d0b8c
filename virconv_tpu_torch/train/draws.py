"""The random draws of a training step, from one explicit generator.

A step draws three kinds of numbers: StVD voxel discard (one uniform per
row of capacity at each discard site), ROI sampling (per stage and sample
three uniform keys over the proposals and ``ROI_PER_IMAGE`` integers in
[0, 2**30), and the hard-sampling stripe start) and FC dropout (one uniform
per activation). Every draw goes through a ``Draws``: from its
``torch.Generator``, or replayed from a list of tensors (to hand a CPU and
a CUDA run, or the JAX package and the port, the same numbers). Each draw
is also appended to ``log``, and what it belongs to to ``kinds``:

* ``('voxel', coords, mask, spatial_shape, entries)``: a StVD site, one
  value per row of the sparse tensor (``voxel_uniform``);
* ``('entry', i, b)``: ROI sampling of batch entry i of b;
* ``('shared',)``: one draw for the whole batch (the stripe start);
* ``('rows',)``: one row per row of the batch's entries, in entry order
  (dropout).

In a data-parallel step each rank draws from its own generator, except
the stripe start, which every rank takes from rank 0. ``for_rank`` maps
the draws of one process's step on the global batch to what rank r of W
draws on its frames (``parallel.data_parallel.shard_frames``): the StVD
values by voxel key (entry, z, y, x), the ROI-sampling draws of the rank's
entries, the shared draws whole and its block of the dropout rows. The
two then take the same step.
"""

from __future__ import annotations

import numpy as np
import torch


class KeyedRows:
    """One StVD site's values keyed by voxel: looked up by the rows of
    another tensor of the same batch's entries (a rank's share) at replay.
    Rows it does not hold (invalid ones) get 1.0, which keeps them."""

    def __init__(self, u, coords, mask, spatial_shape):
        self.spatial_shape = tuple(spatial_shape)
        keys = self._keys(coords.cpu().to(torch.int64), 0)[mask.cpu()]
        order = torch.argsort(keys)
        self.keys = keys[order]
        self.values = torch.as_tensor(u).cpu()[mask.cpu()][order]

    def _keys(self, coords, offset):
        d, h, w = self.spatial_shape
        return (((coords[:, 0] + offset) * d + coords[:, 1]) * h
                + coords[:, 2]) * w + coords[:, 3]

    def resolve(self, st, offset):
        keys = self._keys(st.coords.cpu().to(torch.int64), offset)
        mask = st.mask.cpu()
        out = torch.ones(keys.shape)
        hit = torch.zeros_like(mask)
        if len(self.keys):
            pos = torch.clamp(torch.searchsorted(self.keys, keys),
                              max=len(self.keys) - 1)
            hit = mask & (self.keys[pos] == keys)
            out = torch.where(hit, self.values[pos], out)
        if bool((mask & ~hit).any()):
            raise KeyError('a valid row of the rank has no value at this '
                           'StVD site: the step saw other voxels')
        return out


class Draws:
    def __init__(self, generator: torch.Generator | None = None,
                 replay=None, entry_offset: int = 0):
        """``entry_offset``: the global index of the first batch entry,
        with which a replayed ``KeyedRows`` finds its rows."""
        if (generator is None) == (replay is None):
            raise ValueError('Draws takes a generator or a replay list')
        self.generator = generator
        self.replay = None if replay is None else list(replay)
        self.entry_offset = entry_offset
        self.log = []
        self.kinds = []

    def _next(self, shape, dtype, draw, device, kind, st=None):
        shape = tuple(shape)
        if self.replay is None:
            t = draw()
        else:
            if not self.replay:
                raise IndexError('replay list exhausted')
            t = self.replay.pop(0)
            if isinstance(t, KeyedRows):
                t = t.resolve(st, self.entry_offset)
            if not torch.is_tensor(t):           # numpy: copy (may be
                t = torch.from_numpy(np.array(t))  # read-only)
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f'replayed draw {tuple(t.shape)} {t.dtype}, '
                                 f'asked for {shape} {dtype}')
        self.log.append(t)
        self.kinds.append(kind)
        return t.to(device)

    def uniform(self, shape, device, entry=None):
        """float32 uniform on [0, 1); ``entry`` (i, b): a draw of batch
        entry i of b, else one row per row of the entries (dropout)."""
        gen = self.generator
        return self._next(shape, torch.float32, lambda: torch.rand(
            shape, generator=gen, device=gen.device), device,
            ('entry', *entry) if entry else ('rows',))

    def randint(self, high: int, shape, device, entry=None, shared=False):
        """int64 uniform on [0, high); ``entry`` as ``uniform``, ``shared``
        one draw for the whole batch."""
        gen = self.generator
        return self._next(shape, torch.int64, lambda: torch.randint(
            high, shape, generator=gen, device=gen.device), device,
            ('shared',) if shared else ('entry', *entry) if entry
            else ('rows',))

    def voxel_uniform(self, st):
        """float32 uniform on [0, 1), one per row of capacity of the sparse
        tensor ``st`` (a StVD site)."""
        gen = self.generator
        return self._next(
            (st.capacity,), torch.float32, lambda: torch.rand(
                (st.capacity,), generator=gen, device=gen.device),
            st.feats.device, ('voxel', st.coords, st.mask,
                              tuple(st.spatial_shape), st.batch_size), st)

    def for_rank(self, rank: int, world: int) -> 'Draws':
        """A replay of this step's draws as rank ``rank`` of ``world``
        draws them on its share of the batch (module docstring)."""
        replay, offset = [], None
        for t, kind in zip(self.log, self.kinds):
            if kind[0] == 'voxel':
                _, coords, mask, shape, entries = kind
                offset = rank * entries // world
                replay.append(KeyedRows(t, coords, mask, shape))
            elif kind[0] == 'entry':
                _, i, b = kind
                offset = rank * b // world
                if not offset <= i < (rank + 1) * b // world:
                    continue
                replay.append(t)
            elif kind[0] == 'shared':
                replay.append(t)
            else:
                n = t.shape[0]
                replay.append(t[rank * n // world:(rank + 1) * n // world])
            if torch.is_tensor(replay[-1]):
                replay[-1] = replay[-1].cpu()
        return Draws(replay=replay, entry_offset=offset or 0)
