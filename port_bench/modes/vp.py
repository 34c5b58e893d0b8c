"""Virtual points: ``virconv_tpu_torch``'s
``VirtualPointGenerator.stream`` over prepared KITTI-sized frames, one
frame a forward, one client in a closed loop, on PENet_C2 weights that the
benchmark made from the seed and calibrated (``benchlib/vp_model.py``);
four sampled frames judged against ``refnet.penet`` after the window
(``benchlib/vp_check.py``).

The stream overlaps a frame's host tail with the next frames' forwards, so
an answer (a frame's fused cloud on the host) returns a few frames after
its frame went in: the window counts the clouds returned inside it, and
each unprofiled frame's time is the gap between two returns.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

from benchlib import cells, program_trace, vp_check, vp_model, vp_work
from benchlib.vp_frames import Frames

SAMPLE = 4              # frames the check draws
PROFILED = 4            # frames whose clouds close the traced stretch
ITEMS = 4               # frames of a side in calibrate.py
STAGES = ('penet.enet', 'penet.cspn', 'vp.depth2points')
COUNTERS = ('vp.sparse_pixels', 'vp.virtual_points', 'vp.thinned_points',
            'vp.fused_points')


def generator_class():
    """The program's ``VirtualPointGenerator``; raises at once when it has
    no ``stream`` (a program older than this cell)."""
    from virconv_tpu_torch.models.depth_completion.virtual_points import \
        VirtualPointGenerator
    if not hasattr(VirtualPointGenerator, 'stream'):
        raise RuntimeError('the program has no VirtualPointGenerator.stream,'
                           ' which this cell drives')
    return VirtualPointGenerator


def tail_workers(frames):
    """The program's host threads for the frames' points
    (``TAIL_WORKERS``), which the traffic states: a traffic that asks for
    another count is not this program's."""
    from virconv_tpu_torch.models.depth_completion import virtual_points
    if frames.workers != virtual_points.TAIL_WORKERS:
        raise ValueError(f'the traffic states {frames.workers} host workers,'
                         f' the program has {virtual_points.TAIL_WORKERS}')
    return frames.workers


def program_frames(frames):
    """The pool as ``prepare_frame`` returns frames to the program: its
    calibration as the program's ``Calibration``."""
    from virconv_tpu_torch.utils.calibration import Calibration
    return [prep[:5] + (Calibration(prep[5]),) + prep[6:]
            for prep in frames.pool]


class Capture:
    """The coarse and refined depths of the frames in ``armed``, keyed by
    the frame id the stream last took in (``current``)."""

    def __init__(self, gen):
        self.gen, self.current, self.armed, self.got = gen, None, set(), {}
        self.handle = gen.model.backbone.register_forward_hook(self._coarse)
        complete = gen.complete

        def completed(*args, **kw):
            depth = complete(*args, **kw)
            if self.current in self.armed:
                self.got[self.current]['depth'] = depth
            return depth
        gen.complete = completed

    def _coarse(self, module, inputs, out):
        if self.current in self.armed:
            self.got[self.current] = {
                'coarse': out[2][0, 0].detach().clone()}

    def remove(self):
        self.handle.remove()
        del self.gen.complete


def _window(gen, preps, made, first, seconds, device, prof, cap, keep):
    """The measured window over frames ``first``, ``first + 1``, ...: the
    start, the seconds until the cloud that closed it, and the return time
    of each cloud inside it by frame id."""
    stop = [False]

    def items():
        i = first
        while not stop[0]:
            if prof is not None and i == prof.start:
                prof.before(i, device)
            cap.current = i
            yield i, preps[made(i)]
            i += 1
    returned = {}
    end = None
    cells.reset_peak(device)
    cells.sync(device)
    t0 = time.perf_counter()
    for fid, cloud in gen.stream(items()):
        t = time.perf_counter()
        if prof is not None and fid == prof.start + prof.n - 1:
            prof.after(fid, device)
        keep(fid, cloud)
        if end is None:
            returned[fid] = t
            if t - t0 >= seconds and (prof is None or prof.done):
                stop[0], end = True, t
    cells.sync(device)
    return t0, end - t0, returned


def _fed(cap, fids, preps, pick):
    for i in fids:
        cap.current = i
        yield i, preps[pick(i)]


def frame_seconds(returned, skip=()):
    """Gaps between consecutive returns, leaving out those that end with a
    frame of ``skip``."""
    fids = sorted(returned)
    return [returned[b] - returned[a] for a, b in zip(fids, fids[1:])
            if b not in skip]


def _medians(snap):
    counters = (snap or {}).get('counters', {})
    return {k: float(statistics.median(counters[k])) for k in COUNTERS
            if counters.get(k)}


def run(cell, args, device, t_start, bench_dir, hooks):
    VirtualPointGenerator = generator_class()
    frames = Frames(cell.traffic, cell.config, args.seed)
    preps = program_frames(frames)
    # the reference and its calibration are the check's work: their
    # seconds are not set-up's
    cells.reference_precision()
    t_ref = time.perf_counter()
    ref, sd = vp_model.reference(frames, args.seed, device)
    cells.sync(device)
    ref_s = time.perf_counter() - t_ref
    gen = VirtualPointGenerator(state_dict={k: v.clone() for k, v in
                                            sd.items()}, device=device)
    planted = contextlib.ExitStack()
    planted.enter_context(vp_model.plant(gen.model, hooks.get('fault')))
    workers = tail_workers(frames)
    t = time.perf_counter()
    warm = list(gen.stream((cells.WARM + k, preps[k % len(preps)])
                           for k in range(2 * workers + 1)))
    cells.sync(device)
    pace = (time.perf_counter() - t) / len(warm)
    n_lo = max(SAMPLE + 1, int(0.5 * args.seconds / max(pace, 1e-3)))
    rs = np.random.default_rng([args.seed, 2 ** 33])
    sample = set(int(i) for i in rs.choice(n_lo, SAMPLE, replace=False))
    prof = cells.Profiled(cell, args, bench_dir, max(1, n_lo // 3),
                          PROFILED, STAGES) if args.trace else None
    cap = Capture(gen)
    cap.armed = sample
    clouds = {}

    def keep(fid, cloud):
        if fid in sample:
            clouds[fid] = cloud
    made = cells.Items(frames, 0, args.seconds, pace)
    t0, window_s, returned = _window(gen, preps, made, 0, args.seconds,
                                     device, prof, cap, keep)
    setup_s = t0 - t_start - ref_s
    peak = cells.peak_bytes(device)
    missing = sorted(sample - set(clouds))
    # sampled frames the window did not reach: run after it, outside the
    # metrics, so that the check sees as many frames
    clouds.update(gen.stream(_fed(cap, missing, preps, frames.item)))
    sides = [{'coarse': cap.got[k]['coarse'].cpu(),
              'depth': cap.got[k]['depth'], 'cloud': clouds[k]}
             for k in sorted(sample)]
    cap.remove()
    planted.close()
    del gen, cap, made
    cells.free(device)
    cells.reference_precision()
    numbers = vp_check.judge_frames(ref, frames, device,
                                    [frames.item(k) for k in sorted(sample)],
                                    sides)
    if prof is None:
        return cells.finish(cell, bench_dir, device, len(returned), peak,
                            numbers, metrics={
                                'infer_frames_per_s': len(returned) *
                                frames.frames / window_s,
                                'setup_s': setup_s})
    prof.finish()
    snap = program_trace.program_snapshot()
    skip = set(range(prof.start - workers, prof.start + prof.n))
    h, w = frames.crop
    summary = {'mode': 'vp', 'items': prof.n, 'frames': frames.frames,
               'trace': prof.trace, 'snapshot': snap,
               'span_kernels': vp_work.span_kernels(prof.path, STAGES[:2]),
               'item_host_s': frame_seconds(returned, skip),
               'work': {'enet_ops': vp_work.enet_ops(ref,
                                                     frames.inputs(0, device)),
                        'cspn': vp_work.cspn_ops_bytes(h, w, ref.iters),
                        'cspn_launches': 2 * ref.iters}}
    medians = _medians(snap)
    extra = {'counters': medians}
    if 'vp.virtual_points' in medians:
        extra['depth_in_range_share'] = 100.0 * \
            medians['vp.virtual_points'] / (h * w)
        extra['sparse_share'] = 100.0 * medians['vp.sparse_pixels'] / (h * w)
    return cells.finish(cell, bench_dir, device, len(returned), peak,
                        numbers, prof, summary=summary, extra=extra)


def side(cell, seed, side, device):
    """The check's numbers over the first ``ITEMS`` frames: the program
    (``program``), the reference on TF32 operands (``control``: the
    configuration states float32 with TF32 off), or the program under a
    fault of ``vp_model.FAULTS``."""
    from refnet.depth2points import frame_points
    from refnet.penet import tf32_operands
    frames = Frames(cell.traffic, cell.config, seed)
    cells.reference_precision()
    ref, sd = vp_model.reference(frames, seed, device)
    picks = [frames.item(i) for i in range(ITEMS)]
    sides = []
    if side == 'control':
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with tf32_operands(ref):
            for k in picks:
                coarse, depth = vp_check.reference_frame(
                    ref, frames.inputs(k, device))
                _, rgb_c, _, _, k_mat, calib, lidar, _ = frames.pool[k]
                sides.append({'coarse': coarse, 'depth': depth.numpy(),
                              'cloud': frame_points(depth.numpy(), rgb_c,
                                                    k_mat, calib, lidar)})
    else:
        preps = program_frames(frames)
        tail_workers(frames)
        gen = generator_class()(state_dict={k: v.clone() for k, v in
                                                sd.items()}, device=device)
        cap = Capture(gen)
        cap.armed = set(range(ITEMS))
        with vp_model.plant(gen.model,
                            None if side == 'program' else side):
            clouds = dict(gen.stream(_fed(cap, range(ITEMS), preps,
                                          picks.__getitem__)))
        sides = [{'coarse': cap.got[i]['coarse'].cpu(),
                  'depth': cap.got[i]['depth'], 'cloud': clouds[i]}
                 for i in range(ITEMS)]
        cap.remove()
        del gen, cap
        cells.free(device)
    cells.reference_precision()
    return vp_check.judge_frames(ref, frames, device, picks, sides)
