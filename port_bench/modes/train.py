"""Training: ``virconv_tpu_torch.train.trainer.Trainer.step`` on weights
that the benchmark made from the seed, its first three steps judged
against ``refnet.runner.RefTrainer``."""

from __future__ import annotations

import contextlib
import time

import torch

from benchlib import cells, detector, faults, judge, weights
from benchlib.capture import Capture
from benchlib.traffic import Traffic

PROFILED = 1            # steps of a traced run under the profiler


def _checked_steps(trainer, step, traffic, device,
                   ctx=contextlib.nullcontext):
    """The first three steps, which the check follows and which warm up:
    the side's state for ``judge.judge_steps``, the capture (disarmed),
    and the last step's seconds."""
    params = lambda: {n: p.detach().clone()
                      for n, p in trainer.model.named_parameters()}
    cap = Capture(trainer.model, keep_feats=False)
    cap.armed = True
    side = {'p0': params(), 'losses': []}
    first = 0.0
    for t in range(3):
        tt = time.perf_counter()
        with ctx():
            loss, _ = step(trainer, traffic.item(t))
        cells.sync(device)
        first = time.perf_counter() - tt
        side['losses'].append(float(loss))
        if t == 0:
            side['grads'] = {n: (p.grad if p.grad is not None else
                                 torch.zeros_like(p)).detach().clone()
                             for n, p in trainer.model.named_parameters()}
    side['p3'] = params()
    side['items'] = cap.items
    cap.items = []
    cap.armed = False
    return side, cap, first


def _judged(rcfg, sd, device, seed, total, traffic, side):
    """The reference's three steps from the same weights, in float32."""
    from refnet.runner import RefTrainer
    cells.reference_precision()
    ref = RefTrainer(rcfg, weights.clone(sd), device, seed, total)
    numbers, info = judge.judge_steps(
        ref, [traffic.item(t) for t in range(3)], side)
    return ref, numbers, info


def run(cell, args, device, t_start, bench_dir, hooks):
    from virconv_tpu_torch.train.trainer import Trainer
    pcfg, rcfg, cfg_dict = detector.cfgs(cell)
    total = int(cell.traffic['total_steps'])
    sd = weights.make_state_dict(rcfg, args.seed, device)
    traffic = Traffic(cell.traffic, cfg_dict, args.seed)
    trainer = Trainer(cfg=pcfg, state_dict=weights.clone(sd), device=device,
                      seed=args.seed, total_steps=total)
    step = hooks.get('step', lambda tr, batch: tr.step(batch))
    tf32 = detector.tf32()
    side, cap, first = _checked_steps(trainer, step, traffic, device)
    n_lo = max(2, int(0.5 * args.seconds / max(first, 1e-3)))
    prof = cells.Profiled(cell, args, bench_dir, 3 + max(1, n_lo // 3),
                          PROFILED, detector.STAGES,
                          detector.program_counters) if args.trace else None
    prof_item = []

    def serve(i, batch):
        cap.armed = prof is not None and prof.covers(i)
        step(trainer, batch)
        cells.sync(device)

    def keep(i, _):
        if prof is not None and prof.covers(i):
            prof_item[:] = (i, cap.items.pop())
    made = cells.Items(traffic, 3, args.seconds, first)
    t0, window_s, i, host_s = cells.window(
        made, 3, args.seconds, device, prof, serve, keep)
    setup_s = t0 - t_start
    n_done = i - 3
    window_peak = cells.peak_bytes(device)
    del made
    peak = max(window_peak, cells.peak_bytes(device))
    cap.remove()
    del trainer, cap
    cells.free(device)

    ref, numbers, _ = _judged(rcfg, sd, device, args.seed, total, traffic,
                              side)
    if prof is None:
        return cells.finish(cell, bench_dir, device, n_done, peak, numbers,
                            metrics={'train_frames_per_s': n_done *
                                     traffic.frames / window_s,
                                     'peak_mem_gib': window_peak / 2 ** 30,
                                     'setup_s': setup_s})
    prof.finish()
    k, item = prof_item
    with judge.following(ref.model, item):
        works = [detector.count_work(lambda: ref.forward(traffic.item(k), k),
                                     ref.model, device)]
    summary, extra = detector.summary(cell, prof, works, host_s,
                                      traffic.frames, tf32)
    return cells.finish(cell, bench_dir, device, n_done, peak, numbers,
                        prof, summary=summary, extra=extra)


def side(cell, seed, side, device):
    """The check's numbers over the first three steps: the program
    (``program``), the reference under bf16 autocast (``control``: the
    configuration states float32), or the program under a fault of
    ``benchlib/faults.py``; with the loss gaps of every step and the
    leaves compared."""
    pcfg, rcfg, cfg_dict = detector.cfgs(cell)
    total = int(cell.traffic['total_steps'])
    traffic = Traffic(cell.traffic, cfg_dict, seed)
    sd = weights.make_state_dict(rcfg, seed, device)
    ctx = contextlib.nullcontext
    if side == 'control':
        from refnet.runner import RefTrainer
        subject = RefTrainer(rcfg, weights.clone(sd), device, seed, total)
        step = lambda tr, b: (tr.step(b), None)
        ctx = lambda: torch.autocast(torch.device(device).type,
                                     dtype=torch.bfloat16)
    else:
        from virconv_tpu_torch.train.trainer import Trainer
        subject = Trainer(cfg=pcfg, state_dict=weights.clone(sd),
                          device=device, seed=seed, total_steps=total)
        step = faults.step(side) if side != 'program' else \
            (lambda tr, b: tr.step(b))
    side_state, cap, _ = _checked_steps(subject, step, traffic, device, ctx)
    cap.remove()
    del subject, cap
    cells.free(device)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    _, numbers, info = _judged(rcfg, sd, device, seed, total, traffic,
                               side_state)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = prev
    numbers.update((k, info[k]) for k in ('loss_gaps', 'leaves_compared',
                                          'grad_worst'))
    return numbers
