"""Evaluation CLI of the PyTorch port (``virconv_tpu_torch``).

The counterpart of ``tools/test.py``: evaluate one checkpoint (``--ckpt``)
or poll a directory for ``checkpoint_epoch_*.pth`` (``--eval_all``), write
KITTI-format prediction files (``--save_to_file``), log the recalls and
sec/example, and run the official AP(R40) metric. Runs on CUDA unless
``--device cpu`` is passed. ``--cfg`` is one of the shipped configurations
(``virconv_t``, ``virconv_l``, ``virconv_s``).

    python tools/test_gpu.py --cfg virconv_t --ckpt <file>.pth \\
        --set DATA_CONFIG.DATA_PATH <kitti tree>

Distributed (``--launcher pytorch``, started by torchrun, devices and
``--dist_backend`` as in ``tools/train_gpu.py``): each rank evaluates its
pad + stride shard of the frames, rank 0 merges the dicts and computes the
metric (other ranks return None in the list ``main`` returns). Each
frame's eval-time draws then come from (seed, frame index)
(``eval_one_ckpt``'s ``frame_streams``), so the metric does not depend on
the number of ranks.

    torchrun --nproc_per_node 8 tools/test_gpu.py --launcher pytorch \\
        --cfg virconv_t --ckpt <file>.pth --set DATA_CONFIG.DATA_PATH <tree>
"""

import argparse
import datetime
import logging
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from virconv_tpu_torch import resolve_device  # noqa: E402
from virconv_tpu_torch.config import CONFIGS as SHIPPED  # noqa: E402
from virconv_tpu_torch.config import cfg_from_list  # noqa: E402

CONFIGS = dict(SHIPPED)
LOADER_SEED = 1024            # tools/test.py seeds numpy with 1024


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='evaluate a checkpoint')
    parser.add_argument('--cfg', choices=sorted(CONFIGS),
                        default='virconv_t')
    parser.add_argument('--batch_size', type=int, default=1)
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--eval_all', action='store_true')
    parser.add_argument('--ckpt_dir', type=str, default=None,
                        help='directory --eval_all polls (default: ckpt '
                             'beside the output directory)')
    parser.add_argument('--max_waiting_mins', type=int, default=30)
    parser.add_argument('--save_to_file', action='store_true')
    parser.add_argument('--output_dir', type=str, default=None)
    parser.add_argument('--device', type=str, default='cuda')
    parser.add_argument('--launcher', choices=['none', 'pytorch'],
                        default='none')
    parser.add_argument('--dist_backend', choices=['nccl', 'gloo'],
                        default='nccl')
    parser.add_argument('--set', dest='set_cfgs', default=None,
                        nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = CONFIGS[args.cfg]()
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def main(argv=None):
    args, cfg = parse_args(argv)
    device = resolve_device(args.device)
    from virconv_tpu_torch.parallel.dist import (get_dist_info,
                                                 init_distributed)
    if args.launcher == 'pytorch':
        device = init_distributed(args.dist_backend, device)
    rank, world = get_dist_info()
    from virconv_tpu_torch.train.eval_loop import eval_one_ckpt
    from virconv_tpu_torch.utils.common import create_logger

    output_dir = Path(args.output_dir) if args.output_dir else (
        ROOT / 'output' / args.cfg / args.extra_tag / 'eval')
    output_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(output_dir / (
        'log_eval_%s.txt' % datetime.datetime.now().strftime(
            '%Y%m%d-%H%M%S')) if rank == 0 else None)
    if rank != 0:
        logger.setLevel(logging.WARNING)

    def finish(results):
        if args.launcher == 'pytorch' and world > 1:
            import torch.distributed as dist
            dist.destroy_process_group()
        return results

    def run(ckpt):
        logger.info(f'==> evaluating {ckpt}')
        return eval_one_ckpt(cfg, ckpt, logger, output_dir,
                             batch_size=args.batch_size, device=device,
                             save_to_file=args.save_to_file,
                             seed=LOADER_SEED, dist_eval=world > 1)

    if not args.eval_all:
        if args.ckpt is None:
            raise SystemExit('--ckpt is required without --eval_all')
        return finish([run(args.ckpt)])
    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir \
        else output_dir.parent / 'ckpt'
    results, evaluated = [], set()
    wait_start = time.time()
    while True:
        todo = [c for c in sorted(ckpt_dir.glob('checkpoint_epoch_*.pth'),
                                  key=lambda p: p.stat().st_mtime)
                if str(c) not in evaluated]
        if world > 1:
            # every rank evaluates rank 0's list, in its order
            import torch.distributed as dist
            box = [todo]
            dist.broadcast_object_list(box, src=0)
            todo = box[0]
        if not todo:
            if (time.time() - wait_start) / 60 > args.max_waiting_mins:
                break
            time.sleep(30)
            continue
        for c in todo:
            results.append(run(c))
            evaluated.add(str(c))
        wait_start = time.time()
    return finish(results)


if __name__ == '__main__':
    main()
