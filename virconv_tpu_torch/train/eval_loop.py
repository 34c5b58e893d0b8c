"""Evaluation of one checkpoint over the KITTI loader (``tools/test_gpu.py``).

The port's counterpart of ``virconv_tpu/train/eval_loop.py``, in the same
order: the loader (test-time replicas, eval-time StVD), the forward on the
device, ``post_process_batch``, the recall records, the KITTI prediction
dicts (host WBF, optional ``.txt`` files) and the official AP(R40)
metric; with a process group, over the ranks' shards of the frames.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..datasets import build_dataloader
from ..models.detectors.voxel_rcnn import VoxelRCNN
from ..parallel.dist import get_dist_info, merge_results_dist
from ..utils.jax_weights import load_state_dict_checked
from ..utils.metrics import compute_recall
from ..utils.postprocess import post_process_batch
from .checkpoint import load_checkpoint


@dataclasses.dataclass
class EvalResult:
    """What ``eval_one_ckpt`` logged, and the pieces it computed them from.

    ``seconds``: host seconds by stage over the run: ``loader`` (the
    producer thread's loading and collation), ``forward`` (transfer and
    forward, synchronized), ``post`` (``post_process_batch``, recall, WBF
    and the dicts) and ``metric`` (AP)."""
    result_dict: dict
    result_str: str | None
    det_annos: list
    recalls: dict
    frames: int
    sec_per_example: float
    seconds: dict


def eval_one_ckpt(cfg, ckpt_path, logger, output_dir, batch_size=1,
                  device='cuda', save_to_file=False, max_batches=None,
                  bf16=True, seed=0, dist_eval=False,
                  frame_streams=None) -> EvalResult | None:
    """Evaluate the checkpoint at ``ckpt_path`` (``train/checkpoint.py``)
    on ``cfg.DATA_CONFIG``'s test split. ``device`` defaults to CUDA and
    raises without a card, unless the caller asks for the CPU; ``bf16``:
    bf16 operands in the sparse conv and pool kernels, as
    ``serve.Detector``; ``seed`` seeds the loader's ``RandomState``.
    ``sec_per_example`` is the forward's seconds per frame, as the JAX loop
    logs it.

    With ``dist_eval`` in a ``torch.distributed`` group each rank
    evaluates its pad + stride shard of the frames and ``merge_results_dist``
    brings the dicts to rank 0, which computes the metric and returns the
    result; other ranks return None (as ``virconv_tpu/train/eval_loop.py``).
    The recalls, frames and seconds are the rank's own. ``frame_streams``
    (default: on when sharded): the loader draws each frame's eval-time
    StVD from (seed, frame index), so that the merged dicts do not depend
    on the number of ranks; off, one stream runs through the frames in
    order, as in the JAX package's loader."""
    dev = resolve_device(device)
    rank, world = get_dist_info() if dist_eval else (0, 1)
    dataset, loader = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size, logger=logger,
        seed=seed, num_shards=world, shard_id=rank,
        frame_streams=world > 1 if frame_streams is None else frame_streams)
    model = VoxelRCNN(cfg.MODEL, cfg.DATA_CONFIG,
                      num_class=len(cfg.CLASS_NAMES))
    load_state_dict_checked(model, load_checkpoint(ckpt_path)['model_state'])
    model = model.to(dev).eval()

    det_annos, recalls = [], {}
    seconds = {'forward': 0.0, 'post': 0.0}
    n_frames = 0
    result_dir = Path(output_dir) / 'final_result' / 'data'
    if save_to_file:
        result_dir.mkdir(parents=True, exist_ok=True)

    for bi, (batch, meta) in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model({k: None if v is None else torch.as_tensor(v,
                                                                   device=dev)
                         for k, v in batch.items()}, bf16=bf16)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        seconds['forward'] += t1 - t0
        n_frames += meta['batch_size']
        pred_dicts = post_process_batch(out, cfg.MODEL.POST_PROCESSING,
                                        len(cfg.CLASS_NAMES))
        if meta['gt_boxes'] is not None:
            for bix, pd in enumerate(pred_dicts):
                gtb = meta['gt_boxes'][bix][meta['gt_valid'][bix]]
                for key, (hit, tot) in compute_recall(
                        np.asarray(pd['pred_boxes']), gtb).items():
                    h, t = recalls.get(key, (0, 0))
                    recalls[key] = (h + hit, t + tot)
        det_annos += dataset.generate_prediction_dicts(
            meta, pred_dicts, cfg.CLASS_NAMES,
            output_path=result_dir if save_to_file else None)
        seconds['post'] += time.perf_counter() - t1
    seconds['loader'] = loader.host_seconds

    sec_per_example = seconds['forward'] / max(n_frames, 1)
    if n_frames:
        logger.info('sec_per_example: %.4f' % sec_per_example)
    for key, (hit, tot) in sorted(recalls.items()):
        logger.info('%s: %.4f (%d/%d)' % (key, hit / max(tot, 1), hit, tot))
    if world > 1:
        # file-based partial-result merge (reference eval_utils.py:79-82)
        det_annos = merge_results_dist(
            det_annos, len(dataset), Path(output_dir) / 'tmp_result_merge')
        if rank != 0:
            return None
    result_str, result_dict = None, {}
    t0 = time.perf_counter()
    if det_annos:
        result_str, result_dict = dataset.evaluation(det_annos,
                                                     cfg.CLASS_NAMES)
        if result_str:
            logger.info(result_str)
    seconds['metric'] = time.perf_counter() - t0
    return EvalResult(result_dict, result_str, det_annos, recalls, n_frames,
                      sec_per_example, seconds)
