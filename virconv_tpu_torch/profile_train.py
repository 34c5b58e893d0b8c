"""Where the time of one full-width training step goes, on one card.

    python -m virconv_tpu_torch.profile_train [--cfg virconv_l] [--out DIR]

Takes one training step of the ``--cfg`` model (default VirConv-T) on
``utils/bench_inputs.train_batch_for`` (T: 2 frames x ROT_NUM 3; L: 2
frames) to warm up (which builds the kernels), then traces one step with
``torch.profiler`` (CPU + CUDA). Prints the step's wall time, the device
busy time and its share, each named stage's host and device span (the
forward's voxelize, backbone_3d, bev, rpn, roi_head and loss, then
backward and optimizer), the kernels with the most device time and the
operators with the most host time. Writes the Chrome trace
``train_trace.json.gz`` under DIR (default ``output/``, which git
ignores).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .config import CONFIGS
from .profile_serve import summarize

STAGES = ('voxelize', 'backbone_3d', 'bev', 'rpn', 'roi_head', 'loss',
          'backward', 'optimizer')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default='output')
    ap.add_argument('--cfg', choices=sorted(CONFIGS), default='virconv_t')
    args = ap.parse_args(argv)

    from .train.trainer import Trainer
    from .utils.bench_inputs import train_batch_for
    cfg = CONFIGS[args.cfg]()
    trainer = Trainer(cfg=cfg, device='cuda', seed=0)
    batch = trainer.to_device(train_batch_for(cfg))
    trainer.step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, 'train_trace.json.gz')
    prof.export_chrome_trace(path)
    with gzip.open(path, 'rt') as f:
        report = summarize(json.load(f), wall_ms, stages=STAGES)
    report['top_host_ops_ms_calls'] = [
        [e.key[:100], round(e.self_cpu_time_total / 1e3, 3), e.count]
        for e in sorted(prof.key_averages(),
                        key=lambda e: -e.self_cpu_time_total)[:25]]
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    report.update(card=smi.splitlines()[0] if smi else
                  torch.cuda.get_device_name(0), cfg=args.cfg,
                  peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(json.dumps(report, indent=1))


if __name__ == '__main__':
    main()
