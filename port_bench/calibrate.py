#!/usr/bin/env python3
"""Readings that the correctness limits are set from, several seeds in
one process (no measured window).

    python3 port_bench/calibrate.py --workload t_infer_b2 --seeds 11,12,13 \\
        --sides program,control,half_batch,answer

For each seed and side it prints one JSON line with the numbers the check
compares, as the cell's run mode (``modes/<mode>.py``, its ``side``)
reads them: ``program`` is the program as a run drives it (serving: the
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
    fn = spec.run_mode(cell.traffic['mode'], bench_dir).side
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


if __name__ == '__main__':
    main()
