"""Serving: ``virconv_tpu_torch.serve.Detector`` with one client in a
closed loop, on weights that the benchmark made from the seed, each
sampled request judged against ``refnet.runner.RefDetector``."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import cells, detector, faults, judge, weights
from benchlib.capture import Capture
from benchlib.traffic import Traffic

SAMPLE = 3              # requests the check draws, besides the longest
PROFILED = 3            # requests of a traced run under the profiler
ITEMS = 4               # requests of a side in calibrate.py
FEATS = ('bev', 'pooled', 'stage_cls', 'stage_reg')


def _reference(rcfg, traffic, seed, device):
    """The reference on the weights from the seed, and those weights with
    its batch norms calibrated by one of its forwards."""
    from refnet.runner import RefDetector
    ref = RefDetector(rcfg, weights.make_state_dict(rcfg, seed, device),
                      device)
    calib = traffic.item(detector.CALIBRATE)
    return ref, weights.calibrate_bn(ref.model, lambda: ref.forward(calib))


def _judged(ref, traffic, keys, items, served):
    """Each number's worst over the requests ``keys``."""
    numbers = {}
    for k in keys:
        for name, v in judge.judge_request(ref, traffic.item(k), items[k],
                                           served[k]).items():
            numbers[name] = max(numbers.get(name, 0.0), v)
    return numbers


def run(cell, args, device, t_start, bench_dir, hooks):
    from virconv_tpu_torch.models.roi_heads import voxel_pool
    from virconv_tpu_torch.serve import Detector
    pcfg, rcfg, cfg_dict = detector.cfgs(cell)
    traffic = Traffic(cell.traffic, cfg_dict, args.seed)
    # the reference, and the batch norms' calibration by one of its
    # forwards, are the check's work: their seconds are not set-up's
    t_ref = time.perf_counter()
    ref, sd = _reference(rcfg, traffic, args.seed, device)
    cells.sync(device)
    ref_s = time.perf_counter() - t_ref
    det = Detector(cfg=pcfg, state_dict=weights.clone(sd), device=device)
    if 'detector' in hooks:
        det = hooks['detector'](det)
    tf32 = detector.tf32()
    warm = 0.0
    for k in range(2):
        frames = traffic.item(cells.WARM + k)
        t = time.perf_counter()
        det(frames)
        cells.sync(device)
        warm = time.perf_counter() - t
    n_lo = max(SAMPLE + 1, int(0.5 * args.seconds / max(warm, 1e-3)))
    rs = np.random.default_rng([args.seed, 2 ** 33])
    sample = set(int(i) for i in rs.choice(n_lo, SAMPLE, replace=False))
    sample.add(max(range(n_lo), key=traffic.size))
    prof = cells.Profiled(cell, args, bench_dir, max(1, n_lo // 3),
                          PROFILED, detector.STAGES,
                          detector.program_counters) if args.trace else None
    cap = Capture(det.model, branches=voxel_pool.branch_counts)
    served, items = {}, {}

    def serve(i, frames):
        cap.armed = i in sample or (prof is not None and prof.covers(i))
        return det(frames)

    def keep(i, res):
        if cap.armed:
            items[i] = cap.items.pop()
            served[i] = res
            if i not in sample:     # profiled only: no features to keep
                for key in FEATS:
                    items[i].pop(key, None)
    made = cells.Items(traffic, 0, args.seconds, warm)
    t0, window_s, n_done, host_s = cells.window(
        made, 0, args.seconds, device, prof, serve, keep)
    setup_s = t0 - t_start - ref_s
    peak = cells.peak_bytes(device)
    del made
    cap.armed = True
    for k in sorted(j for j in sample if j >= n_done):
        # a sampled request the window did not reach: served after it,
        # outside the metrics, so that the check sees as many requests
        items[k], served[k] = None, det(traffic.item(k))
        items[k] = cap.items.pop()
    cap.remove()
    del det, cap
    cells.free(device)

    cells.reference_precision()
    numbers = _judged(ref, traffic, sorted(sample), items, served)
    if prof is None:
        return cells.finish(cell, bench_dir, device, n_done, peak, numbers,
                            metrics={'infer_frames_per_s': n_done *
                                     traffic.frames / window_s,
                                     'setup_s': setup_s})
    prof.finish()
    works = []
    for k in range(prof.start, prof.start + prof.n):
        with judge.following(ref.model, items[k]):
            works.append(detector.count_work(
                lambda: ref.forward(traffic.item(k)), ref.model, device))
    summary, extra = detector.summary(
        cell, prof, works, host_s, traffic.frames, tf32,
        [items[k].get('pool_branch', []) for k in
         range(prof.start, prof.start + prof.n)])
    return cells.finish(cell, bench_dir, device, n_done, peak, numbers,
                        prof, summary=summary, extra=extra)


def side(cell, seed, side, device):
    """The check's numbers over the first ``ITEMS`` requests: the program
    (``program``), the reference in float8 e4m3 operands in the sparse
    convs and the ROI pool (``control``: the configuration states bf16),
    or the program under a fault of ``benchlib/faults.py``."""
    from refnet import precision
    pcfg, rcfg, cfg_dict = detector.cfgs(cell)
    traffic = Traffic(cell.traffic, cfg_dict, seed)
    ref, sd = _reference(rcfg, traffic, seed, device)
    mode = None
    if side == 'control':
        from refnet.runner import RefDetector
        subject = RefDetector(rcfg, weights.clone(sd), device)
        mode = 'fp8'
    else:
        from virconv_tpu_torch.serve import Detector
        subject = Detector(cfg=pcfg, state_dict=weights.clone(sd),
                           device=device)
        if side != 'program':
            subject = faults.detector(side)(subject)
    cap = Capture(subject.model)
    cap.armed = True
    served = []
    with precision.use(mode):
        for i in range(ITEMS):
            served.append(subject(traffic.item(i)))
    cap.remove()
    items = cap.items
    del subject, cap
    cells.free(device)
    cells.reference_precision()
    numbers = _judged(ref, traffic, range(ITEMS), items, served)
    torch.backends.cudnn.allow_tf32 = True
    return numbers
