"""Times of the windowed gather convs on one request's layers, on one card.

    python -m virconv_tpu_torch.profile_gather

Captures the neighbor maps and inputs of the 24 submanifold convs of one
full-width VirConv-T request as ``chip_smoke.py`` phase 8 does (run from
the root of a checkout, which holds ``chip_smoke.py``), then times with
CUDA events, on each conv: K5 (``fused_gather_conv``, f32), K6
(``onehot_gather_conv``, bf16 and f32 operands) and K1 (``band_conv``, f32
and bf16). Prints one JSON line with each conv's times and their sums, and
the card's name and power limit. It calls the entry functions only, so run
from another checkout's root it times that checkout's kernels on the same
inputs (A/B runs in one call).
"""

from __future__ import annotations

import json
import subprocess

import torch


def main():
    import chip_smoke as cs
    from .ops import band_conv as bc
    from .ops import gather_conv as gc
    from .ops import onehot_conv as oc
    from .serve import Detector
    from .utils.bench_inputs import FRAMES, synth_frames
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    torch.set_grad_enabled(False)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = Detector(device='cuda', seed=0)
    with cs.SubmCapture() as cap:
        det.forward(synth_frames(FRAMES))
        torch.cuda.synchronize()
    convs = []
    for lay in cs.gather_layers(cap):
        src, nmap, w, plan, keys = (lay[k] for k in ('src', 'nmap', 'w',
                                                     'plan', 'keys'))
        src5, nmap5 = lay['src5'], lay['nmap5']
        convs.append({
            'case': lay['case'], 'c_in': w.shape[1], 'c_out': w.shape[2],
            'k5': cs.cuda_ms(lambda: gc.fused_gather_conv(src5, nmap5, w)),
            'k6_bf16': cs.cuda_ms(lambda: oc.onehot_gather_conv(src, nmap,
                                                                w)),
            'k6_f32': cs.cuda_ms(lambda: oc.onehot_gather_conv(
                src, nmap, w, bf16=False)),
            'k1_f32': cs.cuda_ms(lambda: bc.band_conv(src, keys, plan, w,
                                                      bf16=False)),
            'k1_bf16': cs.cuda_ms(lambda: bc.band_conv(src, keys, plan, w,
                                                       bf16=True))})
    sums = {k: sum(c[k] for c in convs)
            for k in ('k5', 'k6_bf16', 'k6_f32', 'k1_f32', 'k1_bf16')}
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({'convs': convs, 'ms_summed': sums}), flush=True)
    print(card, flush=True)


if __name__ == '__main__':
    main()
