"""The random draws of a training step, from one explicit generator.

A step draws three kinds of numbers: StVD voxel discard (one uniform per
row of capacity at each discard site), ROI sampling (per stage and sample
three uniform keys over the proposals and ``ROI_PER_IMAGE`` integers in
[0, 2**30), and the hard-sampling stripe start) and FC dropout (one uniform
per activation). Every draw goes through a ``Draws``: from its
``torch.Generator``, or replayed from a list of tensors (to hand a CPU and
a CUDA run, or the JAX package and the port, the same numbers). Each draw
is also appended to ``log``.
"""

from __future__ import annotations

import numpy as np
import torch


class Draws:
    def __init__(self, generator: torch.Generator | None = None,
                 replay=None):
        if (generator is None) == (replay is None):
            raise ValueError('Draws takes a generator or a replay list')
        self.generator = generator
        self.replay = None if replay is None else list(replay)
        self.log = []

    def _next(self, shape, dtype, draw, device):
        shape = tuple(shape)
        if self.replay is None:
            t = draw()
        else:
            if not self.replay:
                raise IndexError('replay list exhausted')
            t = self.replay.pop(0)
            if not torch.is_tensor(t):           # numpy: copy (may be
                t = torch.from_numpy(np.array(t))  # read-only)
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f'replayed draw {tuple(t.shape)} {t.dtype}, '
                                 f'asked for {shape} {dtype}')
        self.log.append(t)
        return t.to(device)

    def uniform(self, shape, device):
        """float32 uniform on [0, 1)."""
        gen = self.generator
        return self._next(shape, torch.float32, lambda: torch.rand(
            shape, generator=gen, device=gen.device), device)

    def randint(self, high: int, shape, device):
        """int64 uniform on [0, high)."""
        gen = self.generator
        return self._next(shape, torch.int64, lambda: torch.randint(
            high, shape, generator=gen, device=gen.device), device)
