"""The full-width VirConv-T model over W data-parallel ranks: one
training step over 8 synthetic KITTI-scale frames (8 / W per rank), then
the evaluation of 8 frames x ROT_NUM 3 replicas (3 entries per frame)
with the trained model, merged through the host tail. The counterpart of
``tools/run_fullwidth_mesh.py`` (its inputs, steps, gates and JSON
fields; ``virconv_tpu_torch/parallel/fullwidth.py``): every width, layer,
ROI count and NMS size of the published config, with the same host data
budgets (10 000 voxels, 8192 LiDAR and 16 384 fused points per entry).

    python tools/run_fullwidth_dp_gpu.py                # 8 ranks, the card(s)
    python tools/run_fullwidth_dp_gpu.py --ranks 4 --backend gloo
    python tools/run_fullwidth_dp_gpu.py --device cpu   # 8 gloo ranks, slow

``--backend``: nccl puts rank r on cuda:r and needs a card per rank; gloo
puts every rank on cuda:0 (the only way to run several ranks on one card:
NCCL refuses two ranks on one device); by default nccl when there are
enough cards, else gloo. Runs on CUDA unless ``--device cpu``. Prints
progress lines and one JSON line (the JAX tool's fields, plus the card's
name, the backend, and each rank's peak GiB, step seconds and the step's
sync-BN and gradient all-reduce ms, each collective synchronized and
timed); ``--out`` also writes it to a file. A failed gate raises (exit
code 1).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--ranks', type=int, default=8)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--backend', choices=['nccl', 'gloo'], default=None)
    parser.add_argument('--out', default=None,
                        help='also write the JSON record to this file')
    args = parser.parse_args(argv)
    from virconv_tpu_torch.parallel.fullwidth import run_fullwidth
    rec, _ = run_fullwidth(args.ranks, args.device, args.backend)
    print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1) + '\n')
    return rec


if __name__ == '__main__':
    main()
