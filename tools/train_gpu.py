"""Training CLI of the PyTorch port (``virconv_tpu_torch``).

The counterpart of ``tools/train.py``: the training loader over a KITTI
tree (gt and DA sampling, local and world augmentations, scene swap,
training StVD), ``Trainer`` steps with the optimizer of
``OPTIMIZATION.OPTIMIZER``, one checkpoint per epoch in
``output/<cfg>/<extra_tag>/ckpt`` (the newest ``--max_ckpt_save_num``
kept), loss and learning-rate logs every ``--log_interval`` steps in
``log/``, then the evaluation of the last checkpoint in ``eval/``
(unless ``--no_eval``). Runs on CUDA unless ``--device cpu`` is passed.

Resume: without ``--ckpt`` the newest checkpoint of the output tree is
resumed, as ``tools/train.py`` does. The parameters, the BN statistics,
the optimizer state and the step are restored and the loop starts at the
saved epoch; the step's random draws depend on (seed, step) only, so they
continue as in an uninterrupted run. The loader's augmentation state
(its numpy ``RandomState``) is not saved, as the JAX CLI does not save
numpy's, so a resumed run augments differently from an uninterrupted one.
``--pretrained_model`` loads a port checkpoint's weights only: VirConv-S
(``--cfg virconv_s``, the semi dataset's ``trainsemi`` split) fine-tunes
from a VirConv-T checkpoint that way. ``--cfg`` is one of the shipped
configurations (``virconv_t``, ``virconv_l``, ``virconv_s``).

    python tools/train_gpu.py --cfg virconv_t \\
        --set DATA_CONFIG.DATA_PATH <kitti tree>

Data parallel (``--launcher pytorch``, started by torchrun): W processes,
each on ``cuda:LOCAL_RANK`` (an explicit ``--device cuda:N`` puts every
rank on card N, gloo only) or on the CPU (``--device cpu``, gloo), in a
``torch.distributed`` group of ``--dist_backend`` (nccl by default).
``--batch_size`` is the global batch (default: BATCH_SIZE_PER_GPU x W) and
must divide by W; each rank loads its block of every global batch, with
its own augmentation stream, and ``Trainer(dist=True)`` takes the step of
the global batch (synced BN, global loss normalizers, summed gradients).
Rank 0 alone writes the checkpoints and logs; every rank waits at a
barrier after each save; the evaluation after training is distributed.

    torchrun --nproc_per_node 8 tools/train_gpu.py --launcher pytorch \\
        --cfg virconv_t --set DATA_CONFIG.DATA_PATH <kitti tree>
"""

import argparse
import dataclasses
import datetime
import logging
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from virconv_tpu_torch import resolve_device  # noqa: E402
from virconv_tpu_torch.config import CONFIGS as SHIPPED  # noqa: E402
from virconv_tpu_torch.config import cfg_from_list  # noqa: E402

CONFIGS = dict(SHIPPED)
MODEL_SEED = 666         # tools/train.py's PRNGKey(666): weights and draws
FIXED_SEED = 666         # --fix_random_seed, as tools/train.py
SHUFFLE_SEED = 0         # as tools/train.py: a resumed run's epochs take
                         # the frames in the uninterrupted run's order
EVAL_LOADER_SEED = 1024  # as tools/test_gpu.py


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='train a detector')
    parser.add_argument('--cfg', choices=sorted(CONFIGS),
                        default='virconv_t')
    parser.add_argument('--batch_size', type=int, default=None,
                        help='frames per step over all ranks (default: '
                             'OPTIMIZATION.BATCH_SIZE_PER_GPU x ranks)')
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--ckpt', type=str, default=None,
                        help='checkpoint to resume (default: the newest '
                             'in the output tree)')
    parser.add_argument('--pretrained_model', type=str, default=None)
    parser.add_argument('--fix_random_seed', action='store_true')
    parser.add_argument('--max_ckpt_save_num', type=int, default=30)
    parser.add_argument('--no_eval', action='store_true',
                        help='skip the evaluation of the last checkpoint')
    parser.add_argument('--log_interval', type=int, default=50)
    parser.add_argument('--output_dir', type=str, default=None,
                        help='the run directory (default: '
                             'output/<cfg>/<extra_tag>)')
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


@dataclasses.dataclass
class TrainRun:
    """What ``main`` did. ``steps``: one record per step (epoch, it, step,
    loss, lr, nonfinite_skips, seconds of the step, seconds waited for its
    batch). ``wall_seconds`` spans the training loop, ``wait_seconds`` the
    part of it spent waiting on the loader; ``loader_seconds`` and
    ``frames`` are the producer's host time and frames. In a data-parallel
    run all of it is the rank's own (``checkpoints`` is empty but on rank
    0, ``eval`` None but on rank 0)."""
    trainer: object
    output_dir: Path
    start_epoch: int
    resumed_from: Path | None
    steps: list
    wall_seconds: float
    wait_seconds: float
    loader_seconds: float
    frames: int
    checkpoints: list
    eval: object | None


def main(argv=None, on_start=None, on_step=None):
    """Train as the command line says; returns a ``TrainRun``.
    ``on_start(trainer, start_epoch, resumed_from)`` is called once the
    state is restored, before the first step; ``on_step(record, tb)``
    after each step."""
    args, cfg = parse_args(argv)
    device = resolve_device(args.device)
    from virconv_tpu_torch.parallel.dist import (barrier, get_dist_info,
                                                 init_distributed)
    if args.launcher == 'pytorch':
        device = init_distributed(args.dist_backend, device)
    rank, world = get_dist_info()
    from virconv_tpu_torch.datasets import build_dataloader
    from virconv_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                    load_checkpoint,
                                                    save_checkpoint)
    from virconv_tpu_torch.train.eval_loop import eval_one_ckpt
    from virconv_tpu_torch.train.trainer import Trainer
    from virconv_tpu_torch.utils.common import create_logger, set_random_seed
    from virconv_tpu_torch.utils.jax_weights import load_state_dict_checked
    from virconv_tpu_torch.utils.metrics import MetricsLogger

    output_dir = Path(args.output_dir) if args.output_dir else (
        ROOT / 'output' / args.cfg / args.extra_tag)
    ckpt_dir, eval_dir, log_dir = (output_dir / d
                                   for d in ('ckpt', 'eval', 'log'))
    for d in (ckpt_dir, eval_dir, log_dir):
        d.mkdir(parents=True, exist_ok=True)
    logger = create_logger(log_dir / (
        'log_train_%s.txt' % datetime.datetime.now().strftime(
            '%Y%m%d-%H%M%S')) if rank == 0 else None)
    if rank != 0:
        logger.setLevel(logging.WARNING)
    metrics = MetricsLogger(log_dir / 'tensorboard' if rank == 0 else None)
    logger.info('********** Start training **********')
    logger.info(f'cfg {args.cfg}, device {device}, ranks {world}, '
                f'argv {argv}')
    if args.fix_random_seed:
        set_random_seed(FIXED_SEED)
        loader_seed = FIXED_SEED
    else:
        loader_seed = int(np.random.SeedSequence().generate_state(1)[0])
    if world > 1:
        # each rank's own augmentation stream; the shuffle seed is shared
        loader_seed = int(np.random.SeedSequence(
            [loader_seed, rank]).generate_state(1)[0])

    batch_size = args.batch_size or \
        cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU * world
    if batch_size % world:
        raise ValueError(f'--batch_size {batch_size} (the global batch) '
                         f'does not divide by the {world} ranks')
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS
    dataset, loader = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size // world, logger=logger,
        seed=loader_seed, training=True, shuffle_seed=SHUFFLE_SEED,
        num_shards=world, shard_id=rank)
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        raise RuntimeError(
            f'No training batches: dataset at {cfg.DATA_CONFIG.DATA_PATH} '
            f'is empty or smaller than the batch size ({batch_size}). '
            'Check DATA_CONFIG.DATA_PATH and the info pkls.')
    trainer = Trainer(cfg=cfg, device=device, seed=MODEL_SEED,
                      total_steps=steps_per_epoch * epochs, dist=world > 1)

    start_epoch = 0
    resume = Path(args.ckpt) if args.ckpt else latest_checkpoint(ckpt_dir)
    if resume is not None:
        logger.info(f'Resuming from {resume}')
        ckpt = load_checkpoint(resume)
        if 'optimizer_state' not in ckpt:
            raise ValueError(f'{resume} holds weights only; pass it as '
                             '--pretrained_model to start from them')
        trainer.load_state_dict(ckpt)
        start_epoch = int(ckpt['epoch'])
    elif args.pretrained_model is not None:
        logger.info(f'Loading pretrained model {args.pretrained_model}')
        load_state_dict_checked(
            trainer.model, load_checkpoint(args.pretrained_model)
            ['model_state'])
    if on_start is not None:
        on_start(trainer, start_epoch, resume)

    steps, checkpoints = [], []
    wait = 0.0
    t_loop = time.perf_counter()
    for epoch in range(start_epoch, epochs):
        loader.set_epoch(epoch)
        t_epoch = t_ask = time.perf_counter()
        for it, (batch, _) in enumerate(loader):
            t0 = time.perf_counter()
            lr = trainer.lr()                  # the step applies this
            with metrics.phase('step'):
                loss, tb = trainer.step(batch)
                loss = float(loss)             # waits for the step
            t1 = time.perf_counter()
            wait += t0 - t_ask
            rec = {'epoch': epoch, 'it': it, 'step': trainer.step_count,
                   'loss': loss, 'lr': lr,
                   'nonfinite_skips': int(tb['nonfinite_skips']),
                   'seconds': t1 - t0, 'wait': t0 - t_ask}
            steps.append(rec)
            if on_step is not None:
                on_step(rec, tb)
            if it % args.log_interval == 0:
                logger.info(f'epoch {epoch} it {it}/{steps_per_epoch} '
                            f'loss {loss:.4f} lr {lr:.6f}')
                metrics.scalar('train/loss', loss, trainer.step_count)
                metrics.scalar('meta_data/learning_rate', lr,
                               trainer.step_count)
                metrics.scalars('train', tb, trainer.step_count)
            t_ask = time.perf_counter()
        logger.info('epoch %d done in %.1fs' % (epoch,
                                                 time.perf_counter()
                                                 - t_epoch))
        if rank == 0:
            st = trainer.state_dict()
            checkpoints.append(save_checkpoint(
                ckpt_dir, st['model_state'], epoch + 1,
                st['optimizer_state'], st['step'],
                max_keep=args.max_ckpt_save_num))
        barrier('checkpoint saved')
    wall = time.perf_counter() - t_loop
    metrics.close()
    logger.info('********** Training done **********')

    result = None
    last = latest_checkpoint(ckpt_dir)
    if not args.no_eval and last is not None:
        logger.info(f'==> evaluating {last}')
        result = eval_one_ckpt(cfg, last, logger, eval_dir, batch_size=1,
                               device=device, seed=EVAL_LOADER_SEED,
                               dist_eval=world > 1)
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    if args.launcher == 'pytorch' and world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return TrainRun(trainer, output_dir, start_epoch, resume, steps, wall,
                    wait, loader.host_seconds, loader.frames, checkpoints,
                    result)


if __name__ == '__main__':
    main()
