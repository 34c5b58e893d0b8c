"""The random draws of a training step, from one explicit generator.

A step draws three kinds of numbers: StVD voxel discard (one uniform per
row of capacity at each discard site), ROI sampling (per stage and sample
three uniform keys over the proposals and ``ROI_PER_IMAGE`` integers in
[0, 2**30), and the hard-sampling stripe start) and FC dropout (one uniform
per activation). Every draw goes through a ``Draws`` and its
``torch.Generator``.
"""

from __future__ import annotations

import torch


class Draws:
    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape, device, entry=None):
        """float32 uniform on [0, 1); ``entry`` (i, b): a draw of batch
        entry i of b, else one row per row of the entries (dropout)."""
        gen = self.generator
        return torch.rand(tuple(shape), generator=gen,
                          device=gen.device).to(device)

    def randint(self, high: int, shape, device, entry=None, shared=False):
        """int64 uniform on [0, high); ``entry`` as ``uniform``, ``shared``
        one draw for the whole batch."""
        gen = self.generator
        return torch.randint(high, tuple(shape), generator=gen,
                             device=gen.device).to(device)

    def voxel_uniform(self, st):
        """float32 uniform on [0, 1), one per row of capacity of the sparse
        tensor ``st`` (a StVD site)."""
        gen = self.generator
        return torch.rand((st.capacity,), generator=gen,
                          device=gen.device).to(st.feats.device)
