"""The collectives of a data-parallel training step over a
``torch.distributed`` group: the port's counterpart of
``virconv_tpu/parallel/mesh.py``.

There a 1-D ``dp`` mesh shards the batch entries and GSPMD inserts the
reductions of one logical program: the gradient all-reduce, and every BN
moment and loss normalizer taken over the global batch (the reference's
DDP with ``--sync_bn``). Here each rank runs its own frames, and the model
code asks this module for the same reductions:

* ``sync_moments``: the BN layers' partial sums, all-reduced with a
  gradient (``all_reduce_sum``), so that the input gradient sees the other
  ranks' rows, as GSPMD's does;
* ``global_sum``, ``global_int``: the loss normalizers' counts, all-reduced
  without a gradient (each rank's loss is then its partial of the global
  loss);
* ``entry_offset``: the global index of a rank's first batch entry;
* ``broadcast``: a batch-wide draw taken from rank 0;
* ``allreduce_grads``: one flat SUM all-reduce of every ``.grad`` after
  backward (the partial losses' gradients are summed, not averaged).

All of them act only inside ``synced(group)``, which ``Trainer`` enters
around a step. Outside it (no process group, or a model run alone) they
return their inputs and launch nothing, so the single-device path is the
same code with the same bits. A group of size 1 runs every collective as
an identity: its values, and so the step's bits, equal those without a
group. ``COUNTS`` counts the collectives by kind (calls and bytes);
with ``TIMING`` set each one also synchronizes the device and adds its
host seconds to ``SECONDS``.

``shard_frames`` splits a global batch over the ranks by whole frames (a
frame's transform replicas, entries ``b * R + i``, stay on one rank),
contiguously, as ``shard_batch`` splits the leading axis over the mesh.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

from ..utils import trace

KINDS = ('moments', 'counts', 'broadcast', 'grads', 'params')
COUNTS = {k: {'calls': 0, 'bytes': 0} for k in KINDS}
SECONDS = {k: 0.0 for k in KINDS}
TIMING = False

_GROUP = None          # the group of the step in progress (``synced``)


def reset_counts():
    for k in KINDS:
        COUNTS[k] = {'calls': 0, 'bytes': 0}
        SECONDS[k] = 0.0


@contextlib.contextmanager
def synced(group=None):
    """Within the block the layers and losses reduce over ``group`` (the
    default group when None), which must exist."""
    global _GROUP
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError('synced() needs a torch.distributed process '
                           'group (init_process_group)')
    prev = _GROUP
    _GROUP = group if group is not None else dist.group.WORLD
    try:
        yield
    finally:
        _GROUP = prev


def active() -> bool:
    return _GROUP is not None


def rank_world():
    """(rank, size) in the active group; (0, 1) outside ``synced``."""
    if _GROUP is None:
        return 0, 1
    return dist.get_rank(_GROUP), dist.get_world_size(_GROUP)


def _run(kind, t, fn):
    COUNTS[kind]['calls'] += 1
    COUNTS[kind]['bytes'] += t.numel() * t.element_size()
    if not TIMING:
        fn()
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    SECONDS[kind] += time.perf_counter() - t0


def _all_reduce(t, kind, group):
    _run(kind, t, lambda: dist.all_reduce(t, op=dist.ReduceOp.SUM,
                                          group=group))
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; the gradient of x is the sum over ranks of
    the gradients of y (every rank's partial loss uses y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), 'moments', group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), 'moments',
                           ctx.group), None


def all_reduce_sum(x):
    """Sum of ``x`` over the ranks, differentiable; ``x`` itself outside
    ``synced``."""
    if _GROUP is None:
        return x
    return _AllReduceSum.apply(x, _GROUP)


def sync_moments(*parts):
    """The ranks' sums of each of ``parts`` (partial BN moments and counts),
    in one differentiable all-reduce (span ``sync_bn``). Outside ``synced``
    the parts come back as they are."""
    if _GROUP is None:
        return parts
    with trace.span('sync_bn'):
        flat = all_reduce_sum(torch.cat([p.reshape(-1) for p in parts]))
    out, i = [], 0
    for p in parts:
        out.append(flat[i:i + p.numel()].reshape(p.shape))
        i += p.numel()
    return tuple(out)


def global_sum(x):
    """Sum of the tensor ``x`` (a count) over the ranks, with no gradient;
    ``x`` outside ``synced``."""
    if _GROUP is None:
        return x
    return _all_reduce(x.detach().clone(), 'counts', _GROUP)


def global_int(n: int, device) -> int:
    """Sum of the host integer ``n`` over the ranks; ``n`` outside
    ``synced``."""
    if _GROUP is None:
        return n
    t = torch.tensor([n], dtype=torch.float32, device=device)
    return int(round(float(_all_reduce(t, 'counts', _GROUP)[0])))


def entry_offset(n: int, device) -> int:
    """The global index of this rank's first batch entry, when every rank
    holds ``n`` consecutive entries of the global batch in rank order
    (``shard_frames``, the training loader); 0 outside ``synced``."""
    if _GROUP is None:
        return 0
    rank, world = rank_world()
    counts = torch.zeros(world, dtype=torch.float32, device=device)
    counts[rank] = n
    counts = _all_reduce(counts, 'counts', _GROUP).tolist()
    return int(sum(counts[:rank]))


def broadcast(x):
    """Rank 0's value of the tensor ``x`` on every rank (a batch-wide
    draw); ``x`` outside ``synced``."""
    if _GROUP is None:
        return x
    t = x.contiguous().clone()
    src = dist.get_global_rank(_GROUP, 0)
    _run('broadcast', t, lambda: dist.broadcast(t, src=src, group=_GROUP))
    return t


def allreduce_grads(model: torch.nn.Module):
    """Sum every parameter's ``.grad`` over the ranks in one flat all-reduce
    in parameter order (a missing gradient counts as zeros and is set), so
    that clipping and the update see the same gradients on every rank. A
    no-op outside ``synced``."""
    if _GROUP is None:
        return
    params = [p for p in model.parameters() if p.requires_grad]
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    _all_reduce(flat, 'grads', _GROUP)
    i = 0
    for p in params:
        p.grad = flat[i:i + p.numel()].view_as(p).clone()
        i += p.numel()


@torch.no_grad()
def broadcast_module(model: torch.nn.Module, group=None):
    """Rank 0's parameters and buffers on every rank of ``group`` (the
    default group when None)."""
    group = group if group is not None else dist.group.WORLD
    src = dist.get_global_rank(group, 0)
    for t in list(model.parameters()) + list(model.buffers()):
        _run('params', t, lambda t=t: dist.broadcast(t.data, src=src,
                                                      group=group))


def shard_frames(batch, rank: int, world: int, entries_per_frame=None):
    """Rank ``rank``'s share of a global batch: frames ``[rank * F / W,
    (rank + 1) * F / W)`` of its F frames, with all of their entries.
    ``entries_per_frame``: the transform replicas per frame (default: the
    ``transform_param`` replicas, else 1; a training batch of
    ``utils.bench_inputs.train_batch`` has ROT_NUM). Arrays whose leading
    axis is the entries or the frames are cut; others are kept whole."""
    n = batch['points'].shape[0]
    tp = batch.get('transform_param')
    per_frame = entries_per_frame or (tp.shape[1] if tp is not None else 1)
    frames = n // per_frame
    if n % per_frame or frames % world:
        raise ValueError(f'{n} entries of {per_frame} per frame do not '
                         f'split into whole frames over {world} ranks')
    f0, f1 = rank * frames // world, (rank + 1) * frames // world

    def cut(x):
        if x is None or getattr(x, 'ndim', 0) == 0:
            return x
        if x.shape[0] == n:
            return x[f0 * per_frame:f1 * per_frame]
        if x.shape[0] == frames:
            return x[f0:f1]
        return x
    return {k: cut(v) for k, v in batch.items()}
