"""Run a function on W ranks of a ``torch.distributed`` group in spawned
processes, and one data-parallel training step on them.

``run_ranks(fn, world, payload)`` starts W processes (the ``spawn`` start
method), joins them into a group of ``backend`` through a ``file://``
rendezvous in a fresh directory (no port to collide with), calls
``fn(rank, world, payload)`` in each, and returns their results in rank
order. Payload and results go through ``torch.save`` files (CPU tensors).
A rank that raises, dies or outlives ``timeout`` fails the whole run with
its traceback, and every process is stopped before it returns.

``step_rank`` is such an ``fn``: rank r of W builds a ``Trainer(dist=
True)`` from the payload's weights, takes one step on its frames of the
global batch (``data_parallel.shard_frames``) with its share of the
one-process step's draws (``Draws.for_rank``), and returns the loss, the
terms, the gradients, the parameters, the buffers and what the capacity
caps were asked to hold. Several ranks may share one CUDA card over gloo.

``rank_backend`` picks the backend and the ranks' devices: NCCL puts rank
r on ``cuda:r`` and needs a card per rank; gloo puts every rank on
``cuda:0``, the only way to run several ranks on one card (NCCL refuses
two ranks on one device), or on the CPU.
"""

from __future__ import annotations

import tempfile
import time
import traceback
from pathlib import Path

import torch


def _worker(rank, world, backend, init_file, fn, payload_file, out_file,
            threads):
    import torch.distributed as dist
    torch.set_num_threads(threads)
    try:
        payload = torch.load(payload_file, weights_only=False)
        if backend is None:
            result = fn(rank, world, payload)
        else:
            dist.init_process_group(backend,
                                    init_method=f'file://{init_file}',
                                    rank=rank, world_size=world)
            try:
                result = fn(rank, world, payload)
            finally:
                dist.destroy_process_group()
        torch.save({'ok': result}, out_file)
    except BaseException:
        torch.save({'error': traceback.format_exc()}, out_file)
        raise


def run_ranks(fn, world: int, payload, backend='gloo', timeout=600.0,
              threads=1, tmpdir=None):
    """``[fn(r, world, payload) for r in range(world)]``, each in its own
    process of one group (module docstring); with ``backend`` None no group
    is made (``fn`` starts its own). ``fn`` must be importable (a
    module-level function)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context('spawn')
    with tempfile.TemporaryDirectory(dir=tmpdir) as tmp:
        tmp = Path(tmp)
        torch.save(payload, tmp / 'payload.pt')
        procs = [ctx.Process(target=_worker, args=(
            r, world, backend, str(tmp / 'rendezvous'), fn,
            str(tmp / 'payload.pt'), str(tmp / f'out{r}.pt'), threads),
            daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if time.monotonic() > deadline:
                    raise TimeoutError(f'{world} ranks of {fn.__name__} '
                                       f'still running after {timeout} s')
                if any(p.exitcode not in (None, 0) for p in procs):
                    break               # one failed: the others may hang
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results, errors = [], []
        for r, p in enumerate(procs):
            out = tmp / f'out{r}.pt'
            rec = torch.load(out, weights_only=False) if out.exists() \
                else {'error': f'exit code {p.exitcode}, no result'}
            if 'error' in rec:
                errors.append(f'rank {r}: {rec["error"]}')
            else:
                results.append(rec['ok'])
        if errors:
            raise RuntimeError('\n'.join(errors))
        return results


def rank_backend(world: int, device='cuda', backend=None):
    """(backend, device) of ``world`` ranks asked for on ``device`` with
    ``backend``: "nccl" gives device "cuda", which ``rank_device`` reads as
    ``cuda:<rank>``, and raises with fewer cards than ranks; "gloo" gives
    ``cuda:0`` for every rank (or "cpu"); None picks nccl when every rank
    has a card of its own, else gloo. Raises when CUDA is asked for and
    absent; on the CPU only gloo runs."""
    from .. import resolve_device
    if resolve_device(device).type == 'cpu':
        if backend not in (None, 'gloo'):
            raise ValueError(f'backend {backend!r} on the CPU: only gloo '
                             'runs there')
        return 'gloo', 'cpu'
    cards = torch.cuda.device_count()
    if backend is None:
        backend = 'nccl' if cards >= world else 'gloo'
    if backend == 'nccl':
        if cards < world:
            raise RuntimeError(
                f'nccl puts rank r on cuda:r: {world} ranks need {world} '
                f'cards, this machine has {cards} (gloo shares cuda:0)')
        return 'nccl', 'cuda'
    if backend != 'gloo':
        raise ValueError(f'unknown backend {backend!r}')
    return 'gloo', 'cuda:0'


def rank_device(device: str, rank: int) -> str:
    """The device of rank ``rank`` from ``rank_backend``'s: "cuda" is
    ``cuda:<rank>``, any other is kept."""
    return f'cuda:{rank}' if device == 'cuda' else device


def reset_launches():
    """Every kernel wrapper's launch count a rank reads set to 0."""
    from ..ops import band_conv, gather_rows, nmap_conv, roi_pool
    band_conv.launches = band_conv.dw_launches = 0
    band_conv.patch_launches = roi_pool.launches = 0
    nmap_conv.launches = nmap_conv.dw_launches = 0
    gather_rows.launches = gather_rows.bwd_launches = 0


def launch_counts():
    """The launch counts ``reset_launches`` set to 0, by kernel."""
    from ..ops import band_conv, gather_rows, nmap_conv, roi_pool
    return {'band_conv_fwd': band_conv.launches,
            'band_conv_dw': band_conv.dw_launches,
            'band_conv_patch': band_conv.patch_launches,
            'roi_pool_fwd': roi_pool.launches,
            'nmap_conv': nmap_conv.launches,
            'nmap_conv_dw': nmap_conv.dw_launches,
            'gather_rows': gather_rows.launches,
            'gather_rows_bwd': gather_rows.bwd_launches}


def _cpu(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    return x


def step_rank(rank, world, payload):
    """Data-parallel training steps on rank ``rank`` (module docstring).
    ``payload``: cfg, state_dict, batch (the global batch, numpy), draws
    (the per-rank ``Draws`` list, replayed by the first step) or None (the
    ranks' own generators), device (``rank_device``'s input), and
    optionally entries_per_frame,
    seed, total_steps, steps (default 1), timing (``data_parallel.TIMING``,
    one for all steps or a list, one a step) and setup (an importable
    ``setup(rank, world, payload)`` called first, which may patch the
    process's modules). Returns the first step's loss, terms,
    gradients, parameters, buffers and capacity-cap records, and per step
    its seconds, loss, peak memory,
    collectives (calls, bytes, seconds) and kernel launches."""
    from ..ops import sparse as sp
    from . import data_parallel as dp
    from ..train.trainer import Trainer
    device = rank_device(payload['device'], rank)
    cuda = device.startswith('cuda')
    if cuda:
        torch.cuda.set_device(torch.device(device))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if payload.get('setup') is not None:
        payload['setup'](rank, world, payload)
    trainer = Trainer(payload['cfg'], state_dict=payload['state_dict'],
                      device=device, seed=payload.get('seed', 0),
                      total_steps=payload.get('total_steps', 1000),
                      dist=True)
    model = trainer.model
    batch = dp.shard_frames(payload['batch'], rank, world,
                            payload.get('entries_per_frame'))
    draws = payload['draws'][rank] if payload.get('draws') else None
    timing = payload.get('timing', False)
    records, first = [], None
    for step in range(payload.get('steps', 1)):
        dp.TIMING = timing[step] if isinstance(timing, (list, tuple)) \
            else timing
        dp.reset_counts()
        reset_launches()
        sp.CAP_LOG = [] if step == 0 else None
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, tb = trainer.step(batch, draws)
        loss = float(loss)
        if cuda:
            torch.cuda.synchronize()
        records.append({
            'seconds': time.perf_counter() - t0, 'loss': loss,
            'peak_bytes': torch.cuda.max_memory_allocated() if cuda
            else None,
            'collectives': {k: {**v, 'seconds': dp.SECONDS[k]}
                            for k, v in dp.COUNTS.items()},
            'launches': launch_counts()})
        if step == 0:
            first = {'loss': loss, 'tb': _cpu(tb), 'caps': sp.CAP_LOG,
                     'grads': {n: _cpu(p.grad) for n, p in
                               model.named_parameters()
                               if p.grad is not None},
                     'params': {n: _cpu(p) for n, p in
                                model.named_parameters()},
                     'buffers': {n: _cpu(b) for n, b in
                                 model.named_buffers()}}
        draws = None
    sp.CAP_LOG = None
    return {**first, 'steps': records}
