"""Two entry points: the tiny detector's eval forward, and a
data-parallel training step over n ranks. The port's counterpart of the
root ``__graft_entry__.py``.

``entry(device)`` returns ``(forward, (model, batch))``: the eval forward
of the tiny VirConv-T detector (``configs/tiny.tiny_config``, seeded
weights) and its example arguments, 2 entries of one frame's 2 test-time
replicas (``utils/bench_inputs.tiny_batch``).

``dryrun_multichip(n_ranks, device, backend, draws)`` takes one
``adam_onecycle`` step (LR 0.01, 10 total steps, clip 10) of the
width-shrunk small preset (``configs/tiny.small_config``) on n ranks, one
entry each, and prints its loss. Each rank runs ``parallel/spawn.
step_rank``, the rank function the tests hold against the JAX package's
mesh step. The ranks' devices and backend (``spawn.rank_backend``):

* ``"nccl"``: rank r on ``cuda:r``; raises with fewer cards than ranks;
* ``"gloo"``: every rank on ``cuda:0`` (or the CPU), the only way to run
  several ranks on one card: NCCL refuses two ranks on one device;
* ``None``: nccl when every rank has a card of its own, else gloo.

Both run on CUDA unless the caller passes ``device="cpu"``.

    python -m virconv_tpu_torch.entry          # dryrun_multichip(8)
"""

from __future__ import annotations

import time

import numpy as np

# the dry run's optimizer (the JAX entry's): one-cycle Adam over 10 steps
DRYRUN_OPT = {'OPTIMIZER': 'adam_onecycle', 'LR': 0.01,
              'WEIGHT_DECAY': 0.01, 'MOMS': [0.95, 0.85], 'PCT_START': 0.4,
              'DIV_FACTOR': 10, 'GRAD_NORM_CLIP': 10, 'NUM_EPOCHS': 1}
DRYRUN_TOTAL_STEPS = 10


def entry(device='cuda'):
    """``(forward, (model, batch))``: ``forward(model, batch)`` is the tiny
    T detector's eval forward (module docstring) on ``device``."""
    import torch
    from . import resolve_device
    from .configs.tiny import tiny_config
    from .models.detectors.voxel_rcnn import VoxelRCNN
    from .utils.bench_inputs import tiny_batch
    from .utils.jax_weights import random_init_
    dev = resolve_device(device)
    cfg = tiny_config()
    model = VoxelRCNN(cfg.MODEL, cfg.DATA_CONFIG,
                      num_class=len(cfg.CLASS_NAMES))
    random_init_(model, 0)
    model = model.to(dev).eval()
    batch = {k: None if v is None else torch.as_tensor(v, device=dev)
             for k, v in tiny_batch(np.random.default_rng(0), n_entries=2,
                                    train=False, n_rep=2).items()}

    def forward(model, batch):
        return model(batch)

    return forward, (model, batch)


def dryrun_config():
    """``small_config()`` with the dry run's optimizer."""
    from .configs.tiny import small_config
    cfg = small_config()
    cfg.OPTIMIZATION.update(DRYRUN_OPT)
    return cfg


def dryrun_batch(n_entries: int, n_pts=None):
    """The dry run's global batch: ``n_entries`` training entries of
    ``n_pts`` points (``SMALL_N_PTS`` by default) from ``default_rng(0)``."""
    from .configs.tiny import SMALL_N_PTS
    from .utils.bench_inputs import tiny_batch
    return tiny_batch(np.random.default_rng(0), n_entries=n_entries,
                      n_pts=n_pts or SMALL_N_PTS, train=True)


def dropped_rows(caps):
    """The capacity caps of ``sparse.CAP_LOG`` records that dropped rows:
    (site, capacity, rows asked for) with rows > capacity."""
    return [tuple(c) for c in caps if c[2] > c[1]]


def dryrun_multichip(n_ranks: int, device='cuda', backend=None, draws=None,
                     n_pts=None):
    """One training step of the small preset on ``n_ranks`` ranks, one
    batch entry each (module docstring). ``draws``: None (each rank draws
    from its own generator, as each device of the JAX mesh draws from its
    keys) or a one-process ``Draws`` of a step on the same global batch,
    which each rank replays its share of (``Draws.for_rank``). ``n_pts``:
    points per entry, ``SMALL_N_PTS`` by default, where the strided convs'
    capacity caps drop rows: each rank sizes its caps from its own entry,
    one process from the whole batch (JAX's mesh too), so the two keep
    other rows; at ~80 points no cap binds and the ranks take the one
    process's step. Prints the caps that dropped rows on each rank.
    Returns ``(loss, ranks)``: the global loss and each rank's
    ``step_rank`` record."""
    from .parallel.spawn import rank_backend, run_ranks, step_rank
    t0 = time.time()

    def progress(msg):
        print(f'[dryrun +{time.time() - t0:6.1f}s] {msg}', flush=True)

    backend, rank_dev = rank_backend(n_ranks, device, backend)
    where = {'nccl': 'rank r on cuda:r', 'gloo': f'every rank on '
             f'{rank_dev}'}[backend]
    progress(f'{n_ranks} ranks over {backend}, {where} (nccl needs a card '
             'per rank; gloo shares one)')
    payload = {'cfg': dryrun_config(), 'state_dict': None,
               'batch': dryrun_batch(n_ranks, n_pts),
               'device': rank_dev, 'seed': 0,
               'total_steps': DRYRUN_TOTAL_STEPS, 'entries_per_frame': 1,
               'draws': None if draws is None else
               [draws.for_rank(r, n_ranks) for r in range(n_ranks)]}
    progress('batch built (one entry per rank); starting the ranks')
    ranks = run_ranks(step_rank, n_ranks, payload, backend=backend,
                      timeout=900)
    loss = ranks[0]['loss']
    for r, res in enumerate(ranks):
        progress(f'rank {r}: caps that dropped rows (site, capacity, rows) '
                 f'{dropped_rows(res["caps"])}')
    progress(f'dryrun_multichip({n_ranks}): loss={loss:.4f}')
    return loss, ranks


if __name__ == '__main__':
    dryrun_multichip(8)
