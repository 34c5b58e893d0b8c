"""Process-group helpers: start-up from torchrun's environment, rank info,
barrier, and the evaluation merge.

The port's copy of ``virconv_tpu/parallel/dist.py``, with the same names:
``init_distributed`` reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` (what ``torchrun`` sets) and starts a
``torch.distributed`` group; ``merge_results_dist`` keeps the reference's
shared-filesystem pickle design: each rank dumps its partial result list, a
barrier, then rank 0 interleaves the parts (undoing the loader's pad +
stride sharding, ``datasets/__init__.py``) and truncates to the dataset
size.
"""

from __future__ import annotations

import os
import pickle
import shutil
import time
from pathlib import Path

import torch
import torch.distributed as dist


def init_distributed(backend='nccl', device='cuda'):
    """Start the process group torchrun describes; returns the device this
    rank runs on. With ``WORLD_SIZE`` unset or 1 no group is created and
    ``device`` comes back as given. ``device`` "cuda" without an index
    becomes ``cuda:LOCAL_RANK`` (one card per rank); an explicit index
    (``cuda:0``) is kept, so that ranks may share a card (gloo only: NCCL
    refuses two ranks on one device)."""
    world = int(os.environ.get('WORLD_SIZE', '1'))
    dev = torch.device(device)
    if world <= 1:
        return dev
    rank = int(os.environ['RANK'])
    if dev.type == 'cuda':
        if dev.index is None:
            dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK',
                                                          rank)))
        torch.cuda.set_device(dev)
    elif backend == 'nccl':
        raise ValueError('the nccl backend needs CUDA devices: pass '
                         '--dist_backend gloo with --device cpu')
    dist.init_process_group(backend, init_method='env://', rank=rank,
                            world_size=world)
    return dev


def get_dist_info():
    """(rank, world_size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier(name='barrier'):
    """Every rank waits for the others; a no-op without a group. ``name``
    labels the call site, as in the JAX package."""
    del name
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def merge_results_dist(result_part, size, tmpdir, rank=None,
                       world_size=None, _barrier=None):
    """Merge per-process partial result lists (reference
    ``merge_results_dist``, common_utils.py:174-195).

    Each rank's ``result_part`` holds samples ``rank, rank+W, rank+2W, ...``
    of the padded index space (the loader's pad+stride sharding), so
    ``zip(*parts)`` interleaves them back into dataset order; the pad
    duplicates fall off the truncation to ``size``.

    Returns the ordered full list on rank 0, ``None`` elsewhere.
    ``rank``/``world_size``/``_barrier`` are injectable for tests.
    """
    if rank is None or world_size is None:
        rank, world_size = get_dist_info()
    sync = _barrier if _barrier is not None else barrier
    if world_size == 1:
        return list(result_part)

    tmpdir = Path(tmpdir)
    tmpdir.mkdir(parents=True, exist_ok=True)
    sync('merge_results_dist_start')
    part_file = tmpdir / f'result_part_{rank}.pkl'
    tmp_file = tmpdir / f'.result_part_{rank}.pkl.tmp'
    with open(tmp_file, 'wb') as f:
        pickle.dump(result_part, f)
    os.replace(tmp_file, part_file)   # atomic publish on shared FS
    sync('merge_results_dist_written')

    if rank != 0:
        return None

    part_list = []
    for i in range(world_size):
        pf = tmpdir / f'result_part_{i}.pkl'
        # barrier guarantees the write happened; allow for FS visibility lag
        for _ in range(100):
            if pf.exists():
                break
            time.sleep(0.1)
        else:
            raise RuntimeError(
                f'merge_results_dist: rank 0 cannot see part file {pf} '
                f'(written by rank {i}) after 10s — the barrier guarantees '
                f'the write happened, so this is shared-filesystem '
                f'visibility lag; extend the wait or check the tmpdir mount')
        with open(pf, 'rb') as f:
            part_list.append(pickle.load(f))

    ordered = []
    for group in zip(*part_list):
        ordered.extend(group)
    # ragged tails (when parts are unevenly sized) keep dataset order too
    longest = max(len(p) for p in part_list)
    for j in range(min(len(p) for p in part_list), longest):
        for p in part_list:
            if j < len(p):
                ordered.append(p[j])
    ordered = ordered[:size]
    shutil.rmtree(tmpdir, ignore_errors=True)
    return ordered
