#!/usr/bin/env python3
"""Readings that the correctness limits are set from, several seeds in
one process (no measured window).

    python3 port_bench/calibrate.py --workload t_infer_b2 --seeds 11,12,13 \\
        --sides program,control,half_batch,answer

For each seed and side it prints one JSON line with the numbers the check
compares: ``program`` is the program as a run drives it (serving: the
first four requests; training: the first three steps); ``control`` puts
the reference in the program's place in the next precision below the
configuration's (serving: float8 e4m3 operands in the sparse convs and
the ROI pool, where the configuration states bf16; training: bf16
autocast, where it states float32); any other side is a fault of
``benchlib/faults.py`` planted under the program. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
ITEMS = 4


def main(argv=None, device='cuda', spec_path=None, bench_dir=BENCH):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--sides', default='program,control')
    args = ap.parse_args(argv)
    for path in (bench_dir, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    from benchlib import spec
    cell = spec.load_cell(args.workload, spec_path or os.path.join(
        ROOT, 'BENCHMARK.json'), bench_dir)
    fn = infer_side if cell.traffic['mode'] == 'infer' else train_side
    out = []
    for seed in (int(s) for s in args.seeds.split(',')):
        for side in args.sides.split(','):
            t = time.perf_counter()
            numbers = fn(cell, seed, side, device)
            line = {'workload': cell.name, 'seed': seed, 'side': side,
                    'numbers': numbers,
                    'seconds': time.perf_counter() - t}
            print(json.dumps(line), flush=True)
            out.append(line)
    return out


def infer_side(cell, seed, side, device):
    import torch
    from benchlib import cells, faults, judge, weights
    from benchlib.capture import Capture
    from benchlib.traffic import Traffic
    from refnet import precision
    from refnet.runner import RefDetector
    pcfg, rcfg, cfg_dict = cells._cfgs(cell)
    traffic = Traffic(cell.traffic, cfg_dict, seed)
    ref = RefDetector(rcfg, weights.make_state_dict(rcfg, seed, device),
                      device)
    calib = traffic.item(cells.CALIBRATE)
    sd = weights.calibrate_bn(ref.model, lambda: ref.forward(calib))
    mode = None
    if side == 'control':
        subject = RefDetector(rcfg, weights.clone(sd), device)
        mode = 'fp8'
    else:
        from virconv_tpu_torch.serve import Detector
        subject = Detector(cfg=pcfg, state_dict=weights.clone(sd),
                           device=device)
        if side != 'program':
            subject = faults.detector(side)(subject)
    cap = Capture(subject.model)
    cap.armed = True
    served = []
    with precision.use(mode):
        for i in range(ITEMS):
            served.append(subject(traffic.item(i)))
    cap.remove()
    items = cap.items
    del subject, cap
    cells.free(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers = {}
    for i in range(ITEMS):
        for k, v in judge.judge_request(ref, traffic.item(i), items[i],
                                        served[i]).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    torch.backends.cudnn.allow_tf32 = True
    return numbers


def train_side(cell, seed, side, device):
    import contextlib
    import torch
    from benchlib import cells, faults, judge, weights
    from benchlib.capture import Capture
    from benchlib.traffic import Traffic
    from refnet.runner import RefTrainer
    pcfg, rcfg, cfg_dict = cells._cfgs(cell)
    total = int(cell.traffic['total_steps'])
    traffic = Traffic(cell.traffic, cfg_dict, seed)
    sd = weights.make_state_dict(rcfg, seed, device)
    ctx = contextlib.nullcontext
    if side == 'control':
        subject = RefTrainer(rcfg, weights.clone(sd), device, seed, total)
        step = lambda tr, b: (tr.step(b), None)
        ctx = lambda: torch.autocast(torch.device(device).type,
                                     dtype=torch.bfloat16)
    else:
        from virconv_tpu_torch.train.trainer import Trainer
        subject = Trainer(cfg=pcfg, state_dict=weights.clone(sd),
                          device=device, seed=seed, total_steps=total)
        step = faults.step(side) if side != 'program' else \
            (lambda tr, b: tr.step(b))
    cap = Capture(subject.model, keep_feats=False)
    cap.armed = True
    params = lambda: {n: p.detach().clone()
                      for n, p in subject.model.named_parameters()}
    side_state = {'p0': params(), 'losses': []}
    for t in range(3):
        with ctx():
            loss, _ = step(subject, traffic.item(t))
        side_state['losses'].append(float(loss))
        if t == 0:
            side_state['grads'] = {
                n: (p.grad if p.grad is not None else
                    torch.zeros_like(p)).detach().clone()
                for n, p in subject.model.named_parameters()}
    side_state['p3'] = params()
    side_state['items'] = cap.items
    cap.remove()
    del subject, cap
    cells.free(device)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    cells.reference_precision()
    ref = RefTrainer(rcfg, weights.clone(sd), device, seed, total)
    numbers, info = judge.judge_steps(
        ref, [traffic.item(t) for t in range(3)], side_state)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = prev
    numbers['loss_gaps'] = info['loss_gaps']
    numbers['leaves_compared'] = info['leaves_compared']
    numbers['grad_worst'] = info['grad_worst']
    return numbers


if __name__ == '__main__':
    main()
