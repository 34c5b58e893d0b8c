"""The operand precision of the reference's products.

The reference computes in float32 (``operand`` returns its argument). The
control of the correctness check puts the reference in the program's place
in the next precision below the configuration's: ``use('fp8')`` rounds the
operands of every sparse conv and of the ROI pool's gathered features to
float8 e4m3 (a per-tensor scale keeps them in range), the step below the
bf16 operands that the configuration states for inference. Training's
control runs the reference under bf16 autocast instead, which needs no
rounding here.
"""

from __future__ import annotations

import contextlib

import torch

_MODE = [None]
E4M3_MAX = 448.0


def operand(x):
    """``x`` rounded to the active operand precision (float32: unchanged)."""
    if _MODE[0] != 'fp8' or not x.is_floating_point():
        return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


@contextlib.contextmanager
def use(mode):
    """Round operands as ``mode`` (None or 'fp8') inside the block."""
    prev, _MODE[0] = _MODE[0], mode
    try:
        yield
    finally:
        _MODE[0] = prev
