"""VirConv-T in PyTorch with hand-written CUDA kernels for Hopper.

The counterpart of ``virconv_tpu`` (JAX/Pallas). It imports no JAX and no
module of ``virconv_tpu``; host helpers it needs are kept as its own copies.
Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Raises when CUDA is asked for
    and absent: the port never falls back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA requested but torch.cuda.is_available() is False; '
            'pass device="cpu" to run the plain PyTorch path')
    return dev
