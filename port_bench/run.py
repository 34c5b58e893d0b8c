#!/usr/bin/env python3
"""One run of one cell of the port's benchmark (``virconv_tpu_torch`` on
one H100).

    python3 port_bench/run.py --workload t_train_b2 --seed 7 --seconds 40 --trace 0

Run from the root of a checkout. The cell, its configuration, traffic
mix, per-layer metrics and limits are found by name (``BENCHMARK.json``,
``port_bench/configs``, ``traffic``, ``metrics``, ``limits``). The last
line of standard output is the result JSON: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiled stretch. The check against the plain reference prints each
number beside its limit as the last lines of standard error and under
``checks``, the result's last key. Exits non-zero, with no result, when
there is no CUDA card, when the program cannot be imported, or when JAX
or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'virconv_tpu')


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    each compared whole."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_caches(bench_dir):
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernels build into its ``_build`` directory)."""
    cache = os.path.join(bench_dir, 'cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache,
                                                      'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')


def main(argv=None, device='cuda', spec_path=None, bench_dir=BENCH,
         hooks=None):
    args = parse(argv)
    set_caches(bench_dir)
    import torch
    if device == 'cuda' and not torch.cuda.is_available():
        print('no CUDA card: torch.cuda.is_available() is False',
              file=sys.stderr)
        return 2
    for path in (bench_dir, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    from benchlib import cells, spec
    cell = spec.load_cell(args.workload, spec_path or os.path.join(
        ROOT, 'BENCHMARK.json'), bench_dir)
    if device == 'cuda' and torch.cuda.device_count() < cell.chips:
        print(f'{cell.name} needs {cell.chips} cards, '
              f'{torch.cuda.device_count()} found', file=sys.stderr)
        return 2
    result = cells.run_cell(cell, args, device, T_START, bench_dir, hooks)
    bad = forbidden_modules()
    if bad:
        print(f'loaded in this process: {bad}', file=sys.stderr)
        return 3
    for name, c in result['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
