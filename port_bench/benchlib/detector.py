"""What the two modes of the VoxelRCNN detector (``modes/infer.py``,
``modes/train.py``) share: the configuration as the program's and the
reference's ``CfgNode``, the program's spans and branch counters, the
reference's work count of one forward, and the traced run's summary."""

from __future__ import annotations

import copy

import torch

from .cells import WARM

CALIBRATE = WARM - 1    # the item of the batch-norm calibration
STAGES = ('make_batch', 'voxelize', 'backbone_3d', 'bev', 'rpn',
          'roi_head', 'postprocess_wbf', 'loss', 'backward',
          'allreduce_grads', 'optimizer')


def cfgs(cell):
    from refnet.config import CfgNode as RefCfg
    from virconv_tpu_torch.config import CfgNode as ProgCfg
    d = cell.config['config']
    return ProgCfg(copy.deepcopy(d)), RefCfg(copy.deepcopy(d)), d


def program_counters():
    """The program's branch counters (sparse conv routes, ROI pool routes),
    copied."""
    from virconv_tpu_torch.models.roi_heads import voxel_pool
    from virconv_tpu_torch.ops import sparse
    return (dict(sparse.branch_counts), dict(voxel_pool.branch_counts))


def tf32():
    return {'cudnn': torch.backends.cudnn.allow_tf32,
            'matmul': torch.backends.cuda.matmul.allow_tf32}


def count_work(run_forward, model, device):
    """The reference's tally and dense operation counts of one forward,
    its pool groups also split by grid pool call (``pool_calls``)."""
    from refnet.tally import Tally
    from .capture import pool_modules
    from .work import dense_counter
    counter = dense_counter(model)
    counter['on'] = True
    t = Tally()
    starts = []
    handles = counter['handles'] + [
        m.register_forward_pre_hook(lambda *_: starts.append(len(t.pools)))
        for _, m in pool_modules(model)]
    try:
        with t:
            run_forward()
    finally:
        for h in handles:
            h.remove()
    ends = starts[1:] + [len(t.pools)]
    return {'convs': t.convs, 'pools': t.pools, 'gathers': t.gathers,
            'pool_calls': [t.pools[a:b] for a, b in zip(starts, ends)],
            'dense': {'conv': counter['conv'], 'linear': counter['linear']}}


def summary(cell, prof, works, host_s, frames, tf32, pool_branch=None):
    """What the metric files read (``benchlib/readers.py``), and the
    program's counters over the profiled stretch for the result line."""
    s = {'mode': cell.traffic['mode'], 'items': prof.n, 'frames': frames,
         'trace': prof.trace, 'work': works, 'item_host_s': host_s,
         'tf32': tf32, 'branch_counts': prof.counters[0],
         'pool_counts': prof.counters[1], 'pool_branch': pool_branch}
    return s, {'counters': {'branch': s['branch_counts'],
                            'pool': s['pool_counts']}}
