#!/usr/bin/env python3
"""Drive the PyTorch port (virconv_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. build the CUDA kernels (one nvcc per source, in parallel) and the
     native host box library (g++);
  2. hold every kernel call of one full-width request against its plain
     PyTorch version on the same inputs (captured from a warm-up forward:
     every 3D submanifold, strided, 2D first-wins and conv_out layer, every
     stride-8 and stride-4 pool the kernel runs): f32 and bf16 operands,
     identical ROI selections, kernel and plain times, each call's bound,
     and each kernel's sums over the request;
  3. serve 3 requests of FRAMES=2 synthetic KITTI-scale frames through the
     full-width VirConv-T Detector (ROT_NUM=3, seeded random weights), with
     every launch count set to 0 just before and read just after;
  4. the tiny test configuration on CUDA (kernels) and on the CPU (plain
     versions) with the same weights, TF32 off: final boxes and scores
     compared;
  5. every K1 call (forward, and input gradient with transposed weights)
     and every K4 call of one full-width VirConv-T training step
     (``Trainer.step(train_batch())``: 2 frames x ROT_NUM 3) against its
     plain version, f32 and bf16 operands; each K4 call run twice for
     identical bits and named by its CTA layout (chunks x taps x slabs);
     kernel and plain times with f32 operands, each call's bound at the
     f32 peak, and the sums per step;
  6. the main training path: 3 full-width steps with every launch count
     set to 0 just before and read just after: finite losses, no skipped
     step, both kernels launched, no band training conv on the
     neighbor-map fallback; ms per step and peak memory;
  7. one training step of the tiny configuration on CUDA and on the CPU
     with the same weights and the same random draws (drawn once on the
     CPU), TF32 off: loss and every gradient compared;
  8. the windowed gather convs K5 (``fused_gather_conv``, f32, tile 512)
     and K6 (``onehot_gather_conv``, tile 256, block 2048, bf16 and f32
     operands) on the neighbor maps of all 24 submanifold convs of one
     full-width request (captured from a warm-up forward), once each with
     every launch count set to 0 just before and read just after, each
     call in the mode ``kernel_mode`` picks (row and tile modes both
     launched); then per conv: kernel vs plain (identical misses), and on
     the rows of tiles with no misses whose K1 tile fits, K1's raw output
     with the same operand type (f32: K5 and K6 bit for bit; bf16: within
     1e-4, bit equality reported), kernel, plain and K1 times, the bound;
     sums per request and misses per layer;
  9. the evaluation path: (a) a ``scene`` KITTI tree of EVAL_FRAMES=4
     KITTI-scale val frames, its infos and a seeded full-width VirConv-T
     checkpoint, evaluated by ``eval_one_ckpt`` on CUDA in batches of
     FRAMES=2 (x ROT_NUM 3) with every launch count set to 0 just before
     and read just after: K1 and K2+K3 launched, the native box library
     loaded, one KITTI dict with finite fields and one ``.txt`` per frame,
     the R40 metric keys (the AP values of random weights are printed, not
     gated); sec_per_example, the loader's host seconds per frame and the
     recalls; (b) the tiny configuration's evaluation of a 2-frame ``mini``
     tree on CUDA and on the CPU from one checkpoint, f32: the same frames
     and detection counts, boxes within 5e-3, scores within 2e-3, the same
     recalls and AP dict;
 10. the training path from a KITTI tree: (a) a ``scene`` tree of
     TRAIN_FRAMES=6 frames (4 train with their gt database, 2 val), then
     ``tools/train_gpu.py``'s ``main`` in this process at full-width
     VirConv-T in batches of FRAMES=2 frames: ``--epochs 1 --no_eval``
     (2 steps), then ``--epochs 2``, which resumes at epoch 1, takes 2
     more steps and evaluates the val frames; every launch count set to 0
     just before and read just after, and each step's launches counted:
     finite losses, no skipped step, K1 forward, K1 input gradient and K4
     on every step, the resumed trainer's state equal to the saved file
     (step 2, the schedule's learning rate at 2), K1 and K2+K3 in the
     evaluation; ms per step, peak memory, the loader's host seconds per
     frame and the share of the loop spent waiting on it; (b) the first
     two loader batches of a ``mini`` tree under the tiny training config,
     one step each on the CPU and on CUDA with the CPU's draws replayed:
     phase 7's tolerances;
then one JSON line of per-kernel numbers (times and bounds per request or
per training step, summed over its calls; launches over the phase 3
requests, the phase 6 steps and the phase 8 path, K1's and K2+K3's over
the phase 9a run as ``launches_eval``, and over phase 10a's steps and
evaluation as ``launches_train_cli`` and ``launches_train_cli_eval``)
with phase 9's numbers under ``eval`` and phase 10's under ``train_cli``,
the card's name and power limit, and the device JSON as the last line. Each phase prints its seconds. It needs the repository around it:
alone, or without a CUDA device, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

N_REQUESTS = 3
N_TRAIN_STEPS = 3
EVAL_FRAMES = 4                    # phase 9's scene tree
TRAIN_FRAMES, TRAIN_N_TRAIN = 6, 4  # phase 10's scene tree, its train split
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
BF16_FLOPS, F32_FLOPS = 989e12, 67e12
K5_TILE, K6_TILE = 512, 256        # fused/onehot_gather_conv's default tiles


def fail(msg):
    print(f'FAIL: {msg}', flush=True)
    sys.exit(1)


def cuda_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_done(n, t0):
    """Prints phase ``n``'s seconds since ``t0``; returns the time now."""
    now = time.time()
    print(f'[phase {n}] {now - t0:.1f} s', flush=True)
    return now


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


class Capture:
    """Records the inputs of every kernel call of one warm-up forward (the
    calls still launch the kernels)."""

    def __init__(self):
        from virconv_tpu_torch.ops import band_conv, roi_pool
        self.band, self.pool = [], []
        self._bc, self._rp = band_conv, roi_pool
        self._orig = band_conv._band_conv_cuda, roi_pool._roi_pool_cuda

    def __enter__(self):
        orig_bc, orig_rp = self._orig

        def bc(feats, keys, plan, weights, scale, bias, relu, bf16):
            self.band.append((feats, keys, plan, weights, scale, bias, relu))
            return orig_bc(feats, keys, plan, weights, scale, bias, relu,
                           bf16)

        def rp(plan, fg, w_eff, b_eff, specs, vs, stride, pcr, bf16,
               sel_out=None):
            self.pool.append((plan, fg, w_eff, b_eff, specs, vs, stride, pcr))
            return orig_rp(plan, fg, w_eff, b_eff, specs, vs, stride, pcr,
                           bf16, sel_out)
        self._bc._band_conv_cuda, self._rp._roi_pool_cuda = bc, rp
        return self

    def __exit__(self, *exc):
        self._bc._band_conv_cuda, self._rp._roi_pool_cuda = self._orig
        return False


class TrainCapture:
    """Records the inputs of every K1 and K4 call of one training step (the
    calls still launch the kernels). K1 calls made while the model's
    forward runs are the convs; those after it, in the backward, are the
    input-gradient passes."""

    def __init__(self, model):
        from virconv_tpu_torch.ops import band_conv
        self.fwd, self.dgrad, self.dw = [], [], []
        self._bc, self._model = band_conv, model
        self._orig = band_conv._band_conv_cuda, band_conv._band_conv_dw_cuda
        self._in_forward = False

    def __enter__(self):
        orig_k1, orig_k4 = self._orig
        forward = self._model.forward

        def model_forward(*a, **k):
            self._in_forward = True
            try:
                return forward(*a, **k)
            finally:
                self._in_forward = False

        def k1(feats, keys, plan, weights, scale, bias, relu, bf16):
            calls = self.fwd if self._in_forward else self.dgrad
            calls.append((feats, keys, plan, weights, scale, bias, relu))
            return orig_k1(feats, keys, plan, weights, scale, bias, relu,
                           bf16)

        def k4(feats, keys, plan, g, valid_bits, bf16):
            self.dw.append((feats, keys, plan, g, valid_bits))
            return orig_k4(feats, keys, plan, g, valid_bits, bf16)
        self._model.forward = model_forward
        self._bc._band_conv_cuda, self._bc._band_conv_dw_cuda = k1, k4
        return self

    def __exit__(self, *exc):
        self._bc._band_conv_cuda, self._bc._band_conv_dw_cuda = self._orig
        del self._model.forward
        return False


def band_kind(feats, plan, w):
    k = w.shape[0]
    if k == 27:
        return 'subm3d_k27' if plan.n_out == feats.shape[0] else \
            'strided3d_k27'
    return 'subm2d_k9' if k == 9 else f'out_k{k}'


def taps_hit(feats, keys, plan, valid_bits, row_valid=False):
    """The (row, tap) pairs that have a source in this run's data; with
    ``row_valid`` only those of rows whose row-valid bit is set (K4 skips
    the others)."""
    from virconv_tpu_torch.ops import band_conv as bc
    from virconv_tpu_torch.ops.sparse import ROW_VALID_BIT
    ok = ((valid_bits.reshape(-1) >> ROW_VALID_BIT) & 1) == 1
    return sum(int((hit & ok).sum() if row_valid else hit.sum())
               for _, hit in bc._tap_sources(keys, plan, valid_bits,
                                             feats.shape[0]))


def check_band_case(name, args, bf16_timed=True, peak=BF16_FLOPS):
    """One main-path band-conv call: kernel vs plain (f32 and bf16
    operands), both timed with the path's operands (bf16 at serve, f32 in
    training), and the call's bound at ``peak``."""
    from virconv_tpu_torch.ops import band_conv as bc
    feats, keys, plan, w, scale, bias, relu = args
    line = {'case': name, 'rows_in': feats.shape[0], 'rows_out': plan.n_out,
            'c_in': w.shape[1], 'c_out': w.shape[2], 'taps': w.shape[0]}
    for bf16 in (False, True):
        got = bc.band_conv(feats, keys, plan, w, scale, bias, relu, bf16)
        want = bc.band_conv_plain(feats, keys, plan, w, scale, bias, relu,
                                  bf16)
        err = float((got - want).abs().max())
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        line[f'max_abs_err_{"bf16" if bf16 else "f32"}'] = err
        if not err <= tol:
            fail(f'band_conv {name} bf16={bf16}: max err {err} > {tol}')
    line['ms'] = cuda_ms(lambda: bc.band_conv(feats, keys, plan, w, scale,
                                              bias, relu, bf16_timed))
    line['plain_ms'] = cuda_ms(lambda: bc.band_conv_plain(
        feats, keys, plan, w, scale, bias, relu, bf16_timed), reps=3,
        warmup=1)
    # bound: inputs read once + output written once, and 2*C*C' operations
    # per (row, tap) that has a source in this run's data
    hits = taps_hit(feats, keys, plan, plan.valid_bits)
    line['taps_hit'] = hits
    line['bytes'] = (nbytes(feats, keys, plan.base_keys, plan.valid_bits,
                            plan.blk, w) + plan.n_out * w.shape[2] * 4)
    line['ops'] = 2.0 * hits * w.shape[1] * w.shape[2]
    bound(line, peak)
    return line


def check_dw_case(name, args):
    """One K4 call of the training step: kernel vs plain (f32 and bf16
    operands), two kernel runs with identical bits, both timed with f32
    operands (the training path's), and the call's bound at the f32
    peak."""
    import torch
    from virconv_tpu_torch.ops import band_conv as bc
    feats, keys, plan, g, vb = args
    k, c_in, c_out = len(plan.deltas), feats.shape[1], g.shape[1]
    n_tiles = plan.base_keys.shape[0]
    per_chunk = bc.dw_tiles_per_chunk(n_tiles, plan.tile, k, c_out)
    line = {'case': name, 'rows_in': feats.shape[0], 'rows_out': plan.n_out,
            'c_in': c_in, 'c_out': c_out, 'taps': k,
            'layout': f'{-(-n_tiles // per_chunk)} chunks of {per_chunk} '
                      f'tiles x {k} taps x {-(-c_out // bc.DW_MAX_SLAB)} '
                      f'slab(s)'}
    for bf16 in (False, True):
        got = bc.band_conv_dw(feats, keys, plan, g, vb, bf16)
        again = bc.band_conv_dw(feats, keys, plan, g, vb, bf16)
        if not torch.equal(got, again):
            fail(f'band_conv_dw {name} bf16={bf16}: two runs differ')
        want = bc.band_conv_dw_plain(feats, keys, plan, g, vb, bf16)
        err = float((got - want).abs().max())
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        line[f'max_abs_err_{"bf16" if bf16 else "f32"}'] = err
        if not err <= tol:
            fail(f'band_conv_dw {name} bf16={bf16}: max err {err} > {tol}')
    line['bitwise_repeatable'] = True
    line['ms'] = cuda_ms(lambda: bc.band_conv_dw(feats, keys, plan, g, vb,
                                                 False))
    line['plain_ms'] = cuda_ms(lambda: bc.band_conv_dw_plain(
        feats, keys, plan, g, vb, False), reps=3, warmup=1)
    # bound: inputs read once + dW written once, and 2*C*C' operations per
    # valid (row, tap) that has a source in this run's data
    vb = plan.valid_bits if vb is None else vb
    hits = taps_hit(feats, keys, plan, vb, row_valid=True)
    line['taps_hit'] = hits
    line['bytes'] = (nbytes(feats, keys, plan.base_keys, vb, plan.blk, g)
                     + k * c_in * c_out * 4)
    line['ops'] = 2.0 * hits * c_in * c_out
    bound(line, F32_FLOPS)
    return line


def check_pool_case(name, args):
    """One main-path ROI-pool call: identical selections, kernel vs plain
    (f32 and bf16 features), both timed with bf16, and the call's bound."""
    import torch
    from virconv_tpu_torch.ops import roi_pool as rp
    plan, fg, w_eff, b_eff, specs, vs, stride, pcr = args
    line = {'case': name, 'rois': plan.n_roi, 'queries_per_roi':
            plan.q_per_roi, 'candidate_blocks': int(plan.blk_start[-1]),
            'stride': stride}
    want_sel = rp.roi_pool_selection(plan, specs, vs, stride, pcr)
    got_sel = rp.roi_pool_kernel_selection(plan, fg, w_eff, b_eff, specs,
                                           vs, stride, pcr)
    for g, (a, b) in enumerate(zip(want_sel, got_sel)):
        if not torch.equal(a, b):
            fail(f'roi_pool {name}: group {g} selection differs in '
                 f'{int((a != b).sum())} slots')
    n_sel = sum(int((s >= 0).sum()) for s in want_sel)
    line['selected'] = n_sel
    line['selections_identical'] = True
    for bf16 in (False, True):
        got = rp.roi_pool_apply(plan, fg, w_eff, b_eff, specs, vs, stride,
                                pcr, bf16)
        want = rp.roi_pool_plain(plan, fg, w_eff, b_eff, specs, vs, stride,
                                 pcr, bf16)
        err = float((got - want).abs().max())
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        line[f'max_abs_err_{"bf16" if bf16 else "f32"}'] = err
        if not err <= tol:
            fail(f'roi_pool {name} bf16={bf16}: max err {err} > {tol}')
    line['ms'] = cuda_ms(lambda: rp.roi_pool_apply(
        plan, fg, w_eff, b_eff, specs, vs, stride, pcr, True))
    line['plain_ms'] = cuda_ms(lambda: rp.roi_pool_plain(
        plan, fg, w_eff, b_eff, specs, vs, stride, pcr, True), reps=3,
        warmup=1)
    # bound: plan arrays + the candidate feature rows + output once; ~20
    # operations per (query, candidate, group) distance/window test and ~6
    # per selected (slot, channel)
    n_cand = int(plan.cand_valid.sum())
    mid = fg[0].shape[1]
    line['bytes'] = (nbytes(plan.cand_pack, plan.meta, plan.q_pack,
                            plan.cand_rows, plan.blk_start)
                     + n_cand * mid * len(fg) * 4
                     + plan.n_roi * plan.q_per_roi * len(fg) * mid * 4)
    cand_per_roi = n_cand / max(plan.n_roi, 1)
    line['ops'] = (20.0 * plan.n_roi * plan.q_per_roi * cand_per_roi
                   * len(fg) + 6.0 * n_sel * mid)
    bound(line, F32_FLOPS)
    return line


class SubmCapture:
    """Records every ``sparse.subm_conv_ctx`` call of one forward (its
    sorted tensor, kernel size and whether duplicate keys take first-wins
    sources) and the (feats, weights) of each conv made on it; the convs
    still run."""

    def __init__(self):
        from virconv_tpu_torch.ops import sparse
        self.contexts, self.convs = [], []
        self._sp, self._orig = sparse, sparse.subm_conv_ctx

    def __enter__(self):
        orig = self._orig

        def ctx(st, kernel_size, *a, **kw):
            conv = orig(st, kernel_size, *a, **kw)
            i = len(self.contexts)
            self.contexts.append(
                (st, kernel_size, kw.get('first_wins_sources', False)))

            def recorded(feats, weights, *ca, **ckw):
                self.convs.append((i, feats, weights.detach()))
                return conv(feats, weights, *ca, **ckw)
            return recorded
        self._sp.subm_conv_ctx = ctx
        return self

    def __exit__(self, *exc):
        self._sp.subm_conv_ctx = self._orig
        return False


def gather_layers(cap):
    """The operands of each captured conv: its sources (for the 2D tensor
    the non-first duplicate rows zeroed, as ``subm_conv_ctx`` does), the
    neighbor map, K5's copies padded to its tile (zero rows, -1 map rows),
    and K1's plan and keys of the same layer."""
    import torch
    from virconv_tpu_torch.ops import sparse as sp
    per_ctx, layers = {}, []
    for j, (i, feats, w) in enumerate(cap.convs):
        st, ks, first_wins = cap.contexts[i]
        if i not in per_ctx:
            plan, keys = sp.subm_band_plan(st, ks)
            sel = st.mask
            if first_wins:
                is_first = torch.ones_like(keys, dtype=torch.bool)
                is_first[1:] = keys[1:] != keys[:-1]
                sel = sel & is_first
            per_ctx[i] = (plan, keys, sp.build_subm_neighbor_map(st, ks),
                          sel)
        plan, keys, nmap, sel = per_ctx[i]
        src = torch.where(sel[:, None], feats, torch.zeros_like(feats))
        k, n = w.shape[0], src.shape[0]
        pad = max(-(-n // K5_TILE) * K5_TILE, K5_TILE * k) - n
        layers.append({
            'case': f'{j:02d} ctx{i:02d} {"subm3d" if k == 27 else "subm2d"}'
                    f'_k{k}',
            'src': src, 'nmap': nmap, 'w': w, 'plan': plan, 'keys': keys,
            'src5': torch.nn.functional.pad(src, (0, 0, 0, pad)),
            'nmap5': torch.nn.functional.pad(nmap, (0, 0, 0, pad), value=-1)})
    return layers


def check_windowed(line, label, got, want, k1_out, fits, tile, exact):
    """One windowed gather conv, kernel ``got`` vs plain ``want`` (each
    (out, misses)): identical misses, outputs within 1e-4 x max(1,
    max|plain|); and on the rows of tiles with no misses whose K1 tile
    fits, K1's raw output on the same operands. With ``exact`` (f32
    operands: the same sources summed in the same tap then channel order
    with fmaf) bit for bit; else (bf16 operands: K1's tensor-core body)
    within the same tolerance, and whether the bits agree is recorded.
    Returns the misses."""
    import torch
    (out, miss), (p_out, p_miss) = got, want
    name = f'{line["case"]} {label}'
    if not torch.equal(miss, p_miss):
        fail(f'{name}: kernel and plain misses differ')
    err = float((out - p_out).abs().max())
    tol = 1e-4 * max(1.0, float(p_out.abs().max()))
    if not err <= tol:
        fail(f'{name}: max err {err} > {tol}')
    n = k1_out.shape[0]
    rows = (miss == 0).repeat_interleave(tile)[:n] & fits
    a, b = out[:n][rows], k1_out[rows]
    same = bool(torch.equal(a, b))
    err1 = float((a - b).abs().max()) if bool(rows.any()) else 0.0
    if exact and not same:
        fail(f'{name}: {int((a != b).any(1).sum())} of {int(rows.sum())} '
             f'rows differ from K1 f32 (max {err1})')
    tol1 = 1e-4 * max(1.0, float(k1_out.abs().max()))
    if not err1 <= tol1:
        fail(f'{name}: max err vs K1 {err1} > {tol1}')
    line[f'max_abs_err_{label}'] = err
    line[f'k1_rows_{label}'] = int(rows.sum())
    line[f'k1_err_{label}'] = err1
    line[f'k1_bit_equal_{label}'] = same
    return miss


def check_gather_case(lay, k5, k6, k6f):
    """One submanifold conv through K5 (f32, tile 512) and K6 (tile 256,
    block 2048; bf16 and f32 operands), given the main-path outputs ``k5``,
    ``k6`` (K6 bf16) and ``k6f`` (K6 f32): each against its plain version
    and K1 with the same operand type (f32: bit for bit); times of the
    kernels, of their plain versions and of K1; each call's bound (K6 bf16
    at the bf16 peak, f32 calls at the f32 peak).
    Returns (K5 line, K6 bf16 line, K6 f32 line)."""
    from virconv_tpu_torch.ops import band_conv as bc
    from virconv_tpu_torch.ops import gather_conv as gc
    from virconv_tpu_torch.ops import onehot_conv as oc
    src, nmap, w, plan, keys = (lay[k] for k in ('src', 'nmap', 'w', 'plan',
                                                 'keys'))
    src5, nmap5 = lay['src5'], lay['nmap5']
    n, (k, c_in, c_out) = src.shape[0], w.shape
    fits = plan.fits.repeat_interleave(plan.tile)[:n]
    k1 = {b: bc.band_conv(src, keys, plan, w, bf16=b) for b in (False, True)}
    valid = int((nmap >= 0).sum())
    common = {'case': lay['case'], 'rows': n, 'c_in': c_in, 'c_out': c_out,
              'taps': k, 'mode': gc.kernel_mode(c_in, c_out)}
    l5 = dict(common, rows_padded=src5.shape[0])
    miss5 = check_windowed(l5, 'f32', k5, gc.fused_gather_conv_plain(
        src5, nmap5, w), k1[False], fits, K5_TILE, exact=True)
    l6 = dict(common)
    miss6 = check_windowed(l6, 'bf16', k6, oc.onehot_gather_conv_plain(
        src, nmap, w), k1[True], fits, K6_TILE, exact=False)
    l6f = dict(common)
    miss6f = check_windowed(l6f, 'f32', k6f, oc.onehot_gather_conv_plain(
        src, nmap, w, bf16=False), k1[False], fits, K6_TILE, exact=True)
    l5['ms'] = cuda_ms(lambda: gc.fused_gather_conv(src5, nmap5, w))
    l5['plain_ms'] = cuda_ms(lambda: gc.fused_gather_conv_plain(
        src5, nmap5, w), reps=3, warmup=1)
    l5['k1_ms'] = l6f['k1_ms'] = cuda_ms(
        lambda: bc.band_conv(src, keys, plan, w, bf16=False))
    l6['ms'] = cuda_ms(lambda: oc.onehot_gather_conv(src, nmap, w))
    l6['plain_ms'] = cuda_ms(lambda: oc.onehot_gather_conv_plain(
        src, nmap, w), reps=3, warmup=1)
    l6['k1_ms'] = cuda_ms(lambda: bc.band_conv(src, keys, plan, w,
                                               bf16=True))
    l6f['ms'] = cuda_ms(lambda: oc.onehot_gather_conv(src, nmap, w,
                                                      bf16=False))
    l6f['plain_ms'] = cuda_ms(lambda: oc.onehot_gather_conv_plain(
        src, nmap, w, bf16=False), reps=3, warmup=1)
    # bound: features, map and weights read once, output and misses
    # written once; 2*C*C' operations per in-window (row, tap) hit, at the
    # f32 peak for f32 operands and the bf16 peak for K6's bf16 ones
    for line, f, m, miss, peak in ((l5, src5, nmap5, miss5, F32_FLOPS),
                                   (l6, src, nmap, miss6, BF16_FLOPS),
                                   (l6f, src, nmap, miss6f, F32_FLOPS)):
        line['misses'] = int(miss.sum())
        line['taps_hit'] = valid - line['misses']
        line['bytes'] = (nbytes(f, m, w, miss)
                         + f.shape[0] * c_out * 4)
        line['ops'] = 2.0 * line['taps_hit'] * c_in * c_out
        bound(line, peak)
    return l5, l6, l6f


def gather_conv_phase(det, frames):
    """Phase 8: K5 and K6 over the neighbor maps of every submanifold conv
    of one request (captured from a warm-up forward of ``det``). The path
    (``fused_gather_conv`` once per conv with its defaults, and
    ``onehot_gather_conv`` twice, with its bf16 default and with f32
    operands) runs with every launch count set to 0 just before and read
    just after; each call must have run in the mode ``kernel_mode`` picks.
    Then every call is checked and timed. Returns (counts, per-call lines
    by kernel)."""
    import collections
    import torch
    from virconv_tpu_torch.ops import gather_conv as gc
    from virconv_tpu_torch.ops import onehot_conv as oc
    with SubmCapture() as cap:
        det.forward(frames)
        torch.cuda.synchronize()
    layers = gather_layers(cap)
    taps = [lay['w'].shape[0] for lay in layers]
    print(f'[phase 8] one request: {len(cap.contexts)} submanifold '
          f'contexts, {len(layers)} convs ({taps.count(27)} with K=27, '
          f'{taps.count(9)} with K=9)', flush=True)
    if (len(layers), taps.count(27), taps.count(9)) != (24, 16, 8):
        fail('expected 24 submanifold convs: 16 with K=27, 8 with K=9')
    gc.launches = oc.launches = 0
    gc.mode_launches.clear()
    oc.mode_launches.clear()
    outs = [(gc.fused_gather_conv(lay['src5'], lay['nmap5'], lay['w']),
             oc.onehot_gather_conv(lay['src'], lay['nmap'], lay['w']),
             oc.onehot_gather_conv(lay['src'], lay['nmap'], lay['w'],
                                   bf16=False))
            for lay in layers]
    torch.cuda.synchronize()
    counts = {'gather_conv_fwd': gc.launches,
              'onehot_conv_fwd': oc.launches}
    by_mode = {'gather_conv_fwd': dict(gc.mode_launches),
               'onehot_conv_fwd': dict(oc.mode_launches)}
    print(f'[phase 8] launches over the 24 convs {counts}, by mode '
          f'{json.dumps(by_mode)}', flush=True)
    modes = collections.Counter(gc.kernel_mode(*lay['w'].shape[1:])
                                for lay in layers)
    want = {'gather_conv_fwd': dict(modes),
            'onehot_conv_fwd': {f'{m} {t}': v for m, v in modes.items()
                                for t in ('bf16', 'f32')}}
    if by_mode != want or not {'row', 'tile'} <= set(modes):
        fail(f'launches by mode {by_mode}, expected {want} (row and tile '
             'modes both)')
    cases = {'gather_conv_fwd': [], 'onehot_conv_fwd': [],
             'onehot_conv_fwd_f32': []}
    for lay, (k5, k6, k6f) in zip(layers, outs):
        lines = check_gather_case(lay, k5, k6, k6f)
        for (name, calls), line in zip(cases.items(), lines):
            calls.append(line)
            print(f'[phase 8] {name} {short(line)}', flush=True)
    equal = sum(c['k1_bit_equal_bf16'] for c in cases['onehot_conv_fwd'])
    print(f'[phase 8] on zero-miss fitting rows K5 and K6 f32 equal K1 f32 '
          f'bit for bit on all 24 convs; K6 bf16 equals K1 bf16 bit for bit '
          f'on {equal} of 24', flush=True)
    return counts, by_mode, cases


def bound(line, peak):
    """Sets the case's bound: the larger of its bytes over the memory rate
    and its operations over ``peak``."""
    line['t_bytes_ms'] = 1e3 * line['bytes'] / HBM_BYTES_PER_S
    line['t_ops_ms'] = 1e3 * line['ops'] / peak
    line['bound_ms'] = max(line['t_bytes_ms'], line['t_ops_ms'])
    line['bound_by'] = ('bytes' if line['t_bytes_ms'] >= line['t_ops_ms']
                        else 'operations')
    line['library_ms'] = None      # no single PyTorch call computes it


def summed(lines, unit='request'):
    """One kernel's numbers summed over every call of one request (or
    training step); the bound is that of all the calls' work together."""
    t_bytes = sum(c['t_bytes_ms'] for c in lines)
    t_ops = sum(c['t_ops_ms'] for c in lines)
    return {f'launches_per_{unit}': len(lines),
            'max_abs_err': max(v for c in lines for k, v in c.items()
                               if k.startswith('max_abs_err')),
            'ms': sum(c['ms'] for c in lines),
            'plain_ms': sum(c['plain_ms'] for c in lines),
            'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
            'library_ms': None}


def short(line):
    keep = ('case', 'rows_in', 'rows_out', 'rows', 'c_in', 'c_out', 'taps',
            'layout', 'mode', 'rois', 'queries_per_roi', 'stride',
            'selected', 'misses', 'max_abs_err_f32', 'max_abs_err_bf16',
            'k1_err_f32', 'k1_err_bf16', 'k1_bit_equal_f32',
            'k1_bit_equal_bf16', 'bitwise_repeatable', 'ms', 'plain_ms',
            'k1_ms', 'bound_ms', 'bound_by')
    return json.dumps({k: line[k] for k in keep if k in line})


def tiny_frames(rng, frames=2, n_pts=1500):
    pcr = [0, -8, -3, 16, 8, 1]
    pts = rng.uniform([pcr[0], pcr[1], pcr[2], 0, 0, 0, 0, 1],
                      [pcr[3], pcr[4], pcr[5], 1, 1, 1, 1, 2.01],
                      (frames, n_pts, 8)).astype(np.float32)
    pts[..., 7] = np.round(pts[..., 7])
    valid = np.ones((frames, n_pts), bool)
    valid[:, -50:] = False
    v2r = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0], [0, 0, 0]],
                   np.float32)
    p2t = np.array([[200., 0, 0], [0, 200., 0], [700., 300., 1.],
                    [0, 0, 0]], np.float32)
    return {'points': pts, 'points_valid': valid, 'points_mm': pts.copy(),
            'points_mm_valid': valid.copy(),
            'v2r': np.tile(v2r, (frames, 1, 1)),
            'p2t': np.tile(p2t, (frames, 1, 1))}


def tiny_train_batch(rng, frames=2):
    """tiny_frames() with two gt cars per frame and a world transform per
    entry (each entry is its own sample)."""
    batch = tiny_frames(rng, frames)
    gt = np.zeros((frames, 6, 8), np.float32)
    gt[:, 0] = [4, 0, -1, 3.9, 1.6, 1.56, 0.3, 1]
    gt[:, 1] = [10, 3, -1, 3.9, 1.6, 1.56, -0.5, 1]
    gt_valid = np.zeros((frames, 6), bool)
    gt_valid[:, :2] = True
    batch.update(gt_boxes=gt, gt_valid=gt_valid, transform_param=None,
                 trans_params=np.tile(np.float32([[0.1, 1.0, 1.01]]),
                                      (frames, 1)))
    return batch


def train_kernel_calls(trainer, batch):
    """Phase 5: one training step under TrainCapture, every captured call
    checked and timed. Returns the per-call lines by kernel."""
    import torch
    cap = TrainCapture(trainer.model)
    with cap:
        trainer.step(batch)
    torch.cuda.synchronize()
    print(f'[phase 5] one training step: {len(cap.fwd)} K1 forward, '
          f'{len(cap.dgrad)} K1 input-gradient, {len(cap.dw)} K4 calls',
          flush=True)
    if not (cap.fwd and cap.dgrad and cap.dw):
        fail('the training step missed a kernel use')
    cases = {'band_conv_fwd_train': [], 'band_conv_fwd_train_dgrad': [],
             'band_conv_dw': []}
    with torch.no_grad():
        for key, calls in (('band_conv_fwd_train', cap.fwd),
                           ('band_conv_fwd_train_dgrad', cap.dgrad)):
            for i, a in enumerate(calls):
                line = check_band_case(
                    f'{i:02d} {band_kind(a[0], a[2], a[3])}', a,
                    bf16_timed=False, peak=F32_FLOPS)
                cases[key].append(line)
                print(f'[phase 5] {key} {short(line)}', flush=True)
        for i, a in enumerate(cap.dw):
            line = check_dw_case(f'{i:02d} k{len(a[2].deltas)}', a)
            cases['band_conv_dw'].append(line)
            print(f'[phase 5] band_conv_dw {short(line)}', flush=True)
    return cases


def train_steps(trainer, batch, n_steps):
    """Phase 6, the main training path: ``n_steps`` steps with every launch
    count set to 0 just before and read just after."""
    import torch
    from virconv_tpu_torch.ops import band_conv, sparse
    band_conv.launches = band_conv.dw_launches = 0
    sparse.branch_counts.clear()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, tb = trainer.step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
        bad = [k for k, v in tb.items() if not np.isfinite(float(v))]
        if not np.isfinite(losses[-1]) or bad:
            fail(f'non-finite training loss {losses[-1]} / terms {bad}')
        if tb['nonfinite_skips'] != 0:
            fail(f'{tb["nonfinite_skips"]} skipped steps')
    counts = {'band_conv_fwd': band_conv.launches,
              'band_conv_dw': band_conv.dw_launches}
    branches = dict(sparse.branch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'[phase 6] VirConv-T training, {n_steps} steps of '
          f'{batch["points"].shape[0]} entries: ms/step {times}, loss '
          f'{losses}, peak memory {peak_gib:.2f} GiB, launches {counts}, '
          f'conv branches {branches}', flush=True)
    for k, v in counts.items():
        if v == 0:
            fail(f'{k} was never launched on the training path')
    if branches.get('band_train_nmap', 0) or not branches.get('band_train'):
        fail(f'a band training conv left the band kernels: {branches}')
    return counts, {'ms_per_step': times, 'loss': losses,
                    'peak_memory_gib': peak_gib, 'conv_branches': branches}


def train_step_parity(cfg, batch, devices=('cpu', 'cuda')):
    """One training step of ``cfg`` on ``batch`` on each device, from fresh
    trainers with the same weights and the same draws (made once, on the
    first device, and replayed on the second). Returns (the loss's
    relative error, (the worst gradient error in units of its scale, its
    parameter), the losses): each parameter's gradient error is taken
    against its max |grad| on the first device, floored at 1e-4 x the
    step's largest gradient (gradients that are zero in exact arithmetic
    are round-off)."""
    import torch
    from virconv_tpu_torch.train.draws import Draws
    from virconv_tpu_torch.train.trainer import Trainer
    draws = Draws(torch.Generator().manual_seed(7))
    res = {}
    for d in devices:
        tr = Trainer(cfg=cfg, device=d, seed=1)
        rng = draws if not res else Draws(replay=draws.log)
        loss, _ = tr.step(batch, rng)
        res[d] = (float(loss), {n: p.grad.detach().cpu() for n, p in
                                tr.model.named_parameters()})
    (l_ref, g_ref), (l_dev, g_dev) = res[devices[0]], res[devices[1]]
    floor = 1e-4 * max(float(g.abs().max()) for g in g_ref.values())
    worst = max((float((g_dev[n] - g).abs().max())
                 / max(float(g.abs().max()), floor), n)
                for n, g in g_ref.items())
    loss_rel = abs(l_dev - l_ref) / max(abs(l_ref), 1e-12)
    return loss_rel, worst, (l_ref, l_dev)


def tiny_train_parity(devices=('cpu', 'cuda')):
    """Phase 7: one tiny-config training step on a synthetic batch on each
    device (``train_step_parity``): the loss within rtol 1e-4, each
    gradient within 1e-3 x its scale."""
    from virconv_tpu_torch.configs.tiny import tiny_train_config
    loss_rel, worst, (l_ref, l_dev) = train_step_parity(
        tiny_train_config(), tiny_train_batch(np.random.default_rng(0)),
        devices)
    print(f'[phase 7] tiny config training step {devices[1]} vs '
          f'{devices[0]}: loss {l_dev:.6g} vs {l_ref:.6g} (rel err '
          f'{loss_rel:.3g}, tol 1e-4), worst gradient {worst[1]} at '
          f'{worst[0]:.3g} x its scale (tol 1e-3)', flush=True)
    if not (loss_rel <= 1e-4 and worst[0] <= 1e-3):
        fail('tiny config training step: devices disagree')


R40_KEYS = {f'Car_{m}/{d}_R40' for m in ('3d', 'bev', 'image')
            for d in ('easy', 'moderate', 'hard')}
KITTI_FIELDS = {'name', 'truncated', 'occluded', 'alpha', 'bbox',
                'dimensions', 'location', 'rotation_y', 'score',
                'boxes_lidar', 'frame_id'}


def eval_checkpoint(cfg, ckpt_dir, seed):
    """A checkpoint of seeded random weights of ``cfg``'s model, written by
    the port's ``save_checkpoint``."""
    from virconv_tpu_torch.models.detectors.voxel_rcnn import VoxelRCNN
    from virconv_tpu_torch.train.checkpoint import save_checkpoint
    from virconv_tpu_torch.utils.jax_weights import random_init_
    model = random_init_(VoxelRCNN(cfg.MODEL, cfg.DATA_CONFIG,
                                   num_class=len(cfg.CLASS_NAMES)), seed)
    return save_checkpoint(ckpt_dir, model.state_dict(), epoch=1)


def eval_scene(tmp, frames, batch_size, logger):
    """Phase 9a, the evaluation path at full width: a ``scene`` KITTI tree
    of ``frames`` val frames, its infos, a checkpoint, then
    ``eval_one_ckpt`` on CUDA with every launch count set to 0 just before
    and read just after. Fails unless K1 and K2+K3 were launched, the
    native box library is loaded, each frame has its KITTI dict (finite
    fields) and ``.txt`` file, and the metric has the R40 keys."""
    from virconv_tpu_torch.config import virconv_t_config
    from virconv_tpu_torch.ops import band_conv, native, roi_pool
    from virconv_tpu_torch.train.eval_loop import eval_one_ckpt
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    t = time.perf_counter()
    root = write_tree(tmp / 'scene', 'scene', frames=frames, seed=0)
    write_s = time.perf_counter() - t
    cfg = virconv_t_config()
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    ckpt = eval_checkpoint(cfg, tmp / 'ckpt_full', seed=0)
    out = tmp / 'eval_full'
    band_conv.launches = roi_pool.launches = 0
    res = eval_one_ckpt(cfg, ckpt, logger, out, batch_size=batch_size,
                        device='cuda', save_to_file=True, seed=1024)
    launches = {'band_conv_fwd': band_conv.launches,
                'roi_pool_fwd': roi_pool.launches}
    n_det = [len(a['score']) for a in res.det_annos]
    stats = {'frames': res.frames, 'batch_size': batch_size,
             'tree_write_s': write_s,
             'sec_per_example': res.sec_per_example,
             'loader_sec_per_frame': res.seconds['loader'] / res.frames,
             'seconds': res.seconds, 'launches': launches,
             'recalls': {k: list(v) for k, v in res.recalls.items()},
             'detections_per_frame': n_det,
             'ap_r40': {k: float(v) for k, v in res.result_dict.items()},
             'native_box_ops': native.available()}
    print(f'[phase 9] scene tree of {frames} frames, batches of '
          f'{batch_size} x ROT_NUM {cfg.DATA_CONFIG.ROT_NUM}: '
          f'sec_per_example {res.sec_per_example:.4f}, loader '
          f'{stats["loader_sec_per_frame"]:.4f} s/frame, seconds '
          f'{json.dumps(res.seconds)}, launches {launches}, detections '
          f'{n_det}, recalls {json.dumps(stats["recalls"])}', flush=True)
    print(f'[phase 9] AP(R40) with random weights (not gated): '
          f'{json.dumps(stats["ap_r40"])}', flush=True)
    for k, v in launches.items():
        if v == 0:
            fail(f'{k} was never launched on the evaluation path')
    if not native.available():
        fail('the native box library did not load')
    if res.frames != frames or len(res.det_annos) != frames:
        fail(f'{len(res.det_annos)} prediction dicts for {frames} frames')
    for anno in res.det_annos:
        if set(anno) != KITTI_FIELDS:
            fail(f'prediction dict fields {sorted(anno)}')
        for k in KITTI_FIELDS - {'name', 'frame_id'}:
            if not np.isfinite(np.asarray(anno[k], np.float64)).all():
                fail(f'non-finite {k} in frame {anno["frame_id"]}')
        if not (out / 'final_result' / 'data' /
                f'{anno["frame_id"]}.txt').exists():
            fail(f'no .txt file for frame {anno["frame_id"]}')
    if set(res.result_dict) != R40_KEYS:
        fail(f'metric keys {sorted(res.result_dict)}')
    return stats


def eval_tiny_parity(tmp, logger, devices=('cuda', 'cpu')):
    """Phase 9b: the tiny configuration's evaluation of a 2-frame ``mini``
    tree on CUDA (kernels) and on the CPU (plain versions) from one
    checkpoint, f32 operands: the same frames and detection counts, boxes
    within 5e-3 and scores within 2e-3 (phase 4's tolerances), the same
    recalls and AP dict."""
    from virconv_tpu_torch.configs.tiny import tiny_eval_config
    from virconv_tpu_torch.train.eval_loop import eval_one_ckpt
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    root = write_tree(tmp / 'mini', 'mini', frames=2, seed=0, n_train=0)
    cfg = tiny_eval_config(root)
    ckpt = eval_checkpoint(cfg, tmp / 'ckpt_tiny', seed=1)
    res = {d: eval_one_ckpt(cfg, ckpt, logger, tmp / f'eval_tiny_{d}',
                            batch_size=2, device=d, bf16=False, seed=1024)
           for d in devices}
    a, b = (res[d] for d in devices)
    same = ([x['frame_id'] for x in a.det_annos]
            == [x['frame_id'] for x in b.det_annos]
            and [len(x['score']) for x in a.det_annos]
            == [len(x['score']) for x in b.det_annos])
    box_err = score_err = float('nan')
    if same:
        box_err = max([float(np.abs(x['boxes_lidar'] - y['boxes_lidar'])
                             .max(initial=0)) for x, y in
                       zip(a.det_annos, b.det_annos)])
        score_err = max([float(np.abs(x['score'] - y['score'])
                               .max(initial=0)) for x, y in
                         zip(a.det_annos, b.det_annos)])
    n_det = [len(x['score']) for x in a.det_annos]
    ap_same = a.result_dict == b.result_dict and a.recalls == b.recalls
    print(f'[phase 9] tiny config evaluation {devices[0]} vs {devices[1]}: '
          f'detections {n_det}, same frames and counts {same}, box max err '
          f'{box_err:.3g} (tol 5e-3), score max err {score_err:.3g} (tol '
          f'2e-3), recalls and AP equal {ap_same}', flush=True)
    if not (same and sum(n_det) > 0 and box_err <= 5e-3
            and score_err <= 2e-3 and ap_same):
        fail('tiny config evaluation: devices disagree')
    return {'detections_per_frame': n_det, 'box_max_err': box_err,
            'score_max_err': score_err, 'recalls_and_ap_equal': ap_same}


class StepCounts:
    """Counts the K1 forward, K1 input-gradient, K4 and K2+K3 launches of
    each training step of ``trainer`` (read and reset by ``take``), as
    ``TrainCapture`` tells K1's forward calls (while the model's forward
    runs) from its input-gradient calls; the wrapped functions still
    launch the kernels and bump the modules' own counts."""

    KEYS = ('k1_forward', 'k1_input_grad', 'k4', 'k2_k3')

    def __init__(self, trainer):
        from virconv_tpu_torch.ops import band_conv, roi_pool
        self._bc, self._rp, self._model = band_conv, roi_pool, trainer.model
        self._orig = (band_conv._band_conv_cuda,
                      band_conv._band_conv_dw_cuda, roi_pool._roi_pool_cuda)
        self._in_forward = False
        self.counts = dict.fromkeys(self.KEYS, 0)

    def __enter__(self):
        k1, k4, pool = self._orig
        forward = self._model.forward

        def model_forward(*a, **k):
            self._in_forward = True
            try:
                return forward(*a, **k)
            finally:
                self._in_forward = False

        def counted(key, fn):
            def call(*a, **k):
                if key == 'k1':
                    name = 'k1_forward' if self._in_forward \
                        else 'k1_input_grad'
                else:
                    name = key
                self.counts[name] += 1
                return fn(*a, **k)
            return call
        self._model.forward = model_forward
        self._bc._band_conv_cuda = counted('k1', k1)
        self._bc._band_conv_dw_cuda = counted('k4', k4)
        self._rp._roi_pool_cuda = counted('k2_k3', pool)
        return self

    def take(self):
        out, self.counts = self.counts, dict.fromkeys(self.KEYS, 0)
        return out

    def __exit__(self, *exc):
        (self._bc._band_conv_cuda, self._bc._band_conv_dw_cuda,
         self._rp._roi_pool_cuda) = self._orig
        del self._model.forward
        return False


def tree_equal(got, want):
    """Nested dicts of tensors and numbers equal, tensors bit for bit."""
    import torch
    if isinstance(want, dict):
        return set(got) == set(want) and all(tree_equal(got[k], want[k])
                                             for k in want)
    if torch.is_tensor(want):
        return torch.equal(got.detach().cpu(), want)
    return got == want


def train_cli_scene(tmp, frames, n_train, batch_size):
    """Phase 10a: ``tools/train_gpu.py``'s ``main`` in this process at
    full-width VirConv-T on a ``scene`` tree of ``frames`` frames
    (``n_train`` in the train split, with its gt database): one epoch with
    ``--no_eval``, then ``--epochs 2``, which resumes at epoch 1 and
    evaluates the val frames. Every launch count is set to 0 just before
    and read just after, and each step's launches are counted. Fails
    unless every loss is finite with no skipped step, K1 (forward and
    input gradient) and K4 ran on every step, the resumed trainer's state
    equals the saved file before its first step (step and learning rate
    included), and the evaluation launched K1 and K2+K3."""
    import torch
    from virconv_tpu_torch.ops import band_conv, roi_pool
    from virconv_tpu_torch.train.checkpoint import load_checkpoint
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))
    import train_gpu
    t = time.perf_counter()
    root = write_tree(tmp / 'train_scene', 'scene', frames=frames, seed=0,
                      n_train=n_train)
    write_s = time.perf_counter() - t
    steps_per_epoch = n_train // batch_size
    argv = ['--cfg', 'virconv_t', '--batch_size', str(batch_size),
            '--output_dir', str(tmp / 'train_run'), '--log_interval', '1',
            '--fix_random_seed', '--set', 'DATA_CONFIG.DATA_PATH', str(root)]
    state = {'counter': None, 'steps': [], 'resume': None}

    def on_start(trainer, start_epoch, resumed_from):
        if resumed_from is not None:
            saved = load_checkpoint(resumed_from)
            got = trainer.state_dict()
            state['resume'] = {
                'start_epoch': start_epoch, 'step': got['step'],
                'lr': trainer.lr(),
                'lr_fn_at_step': float(trainer.optimizer.lr_fn(
                    saved['step'])),
                'model_equal': tree_equal(got['model_state'],
                                          saved['model_state']),
                'optimizer_equal': tree_equal(got['optimizer_state'],
                                              saved['optimizer_state'])}
        state['counter'] = StepCounts(trainer).__enter__()

    def on_step(rec, tb):
        torch.cuda.synchronize()
        state['steps'].append({
            **rec, **state['counter'].take(),
            'terms_finite': all(np.isfinite(float(v)) for v in tb.values()),
            'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30})

    band_conv.launches = band_conv.dw_launches = roi_pool.launches = 0
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for extra in (['--epochs', '1', '--no_eval'], ['--epochs', '2']):
        try:
            runs.append(train_gpu.main(extra + argv, on_start, on_step))
        finally:
            if state['counter'] is not None:
                eval_counts = state['counter'].take()
                state['counter'].__exit__()
                state['counter'] = None
    counts = {'band_conv_fwd': band_conv.launches,
              'band_conv_dw': band_conv.dw_launches,
              'roi_pool_fwd': roi_pool.launches}
    # the evaluation builds its own model: all its K1 calls are forward
    eval_counts = {'band_conv_fwd': eval_counts['k1_forward']
                   + eval_counts['k1_input_grad'],
                   'roi_pool_fwd': eval_counts['k2_k3']}
    steps = state['steps']
    ms = [1e3 * r['seconds'] for r in steps]
    wall = sum(r.wall_seconds for r in runs)
    wait = sum(r.wait_seconds for r in runs)
    frames_loaded = sum(r.frames for r in runs)
    res = runs[1].eval
    stats = {'frames': frames, 'train_frames': n_train,
             'batch_size': batch_size, 'tree_write_s': write_s,
             'steps': len(steps), 'ms_per_step': ms,
             'ms_per_step_after_first': float(np.mean(ms[1:])),
             'loss': [r['loss'] for r in steps],
             'lr': [r['lr'] for r in steps],
             'peak_memory_gib': max(r['peak_gib'] for r in steps),
             'loader_sec_per_frame': sum(r.loader_seconds for r in runs)
             / max(frames_loaded, 1),
             'loader_frames': frames_loaded,
             'loop_wall_s': wall, 'loader_wait_s': wait,
             'wait_share': wait / wall,
             'launches_per_step': [{k: r[k] for k in StepCounts.KEYS}
                                   for r in steps],
             'launches': counts, 'launches_eval': eval_counts,
             'resume': state['resume'],
             'eval_frames': res.frames if res else 0,
             'sec_per_example': res.sec_per_example if res else None}
    print(f'[phase 10] train_gpu on a scene tree ({n_train} train, '
          f'{frames - n_train} val frames), batches of {batch_size}: '
          f'{len(steps)} steps, ms/step {[round(x, 1) for x in ms]}, loss '
          f'{[round(x, 4) for x in stats["loss"]]}, lr {stats["lr"]}, peak '
          f'memory {stats["peak_memory_gib"]:.2f} GiB, loader '
          f'{stats["loader_sec_per_frame"]:.4f} s/frame over '
          f'{frames_loaded} frames, waiting on the loader '
          f'{wait:.2f} of {wall:.2f} s ({100 * stats["wait_share"]:.1f} %)',
          flush=True)
    print(f'[phase 10] launches per step {stats["launches_per_step"]}, '
          f'evaluation {eval_counts}, resume {state["resume"]}', flush=True)
    if len(steps) != 2 * steps_per_epoch:
        fail(f'{len(steps)} training steps, expected {2 * steps_per_epoch}')
    for r in steps:
        if not (np.isfinite(r['loss']) and r['terms_finite']):
            fail(f'non-finite loss or terms at step {r["step"]}')
        if r['nonfinite_skips'] != 0:
            fail(f'{r["nonfinite_skips"]} skipped steps')
        if not (r['k1_forward'] and r['k1_input_grad'] and r['k4']):
            fail(f'step {r["step"]} missed a kernel: {r}')
    rs = state['resume']
    if not (rs and rs['start_epoch'] == 1 and rs['step'] == steps_per_epoch
            and rs['model_equal'] and rs['optimizer_equal']
            and rs['lr'] == rs['lr_fn_at_step']):
        fail(f'the resumed trainer does not hold the saved state: {rs}')
    if runs[0].resumed_from is not None or steps[steps_per_epoch]['step'] \
            != steps_per_epoch + 1:
        fail('the second run did not continue the first')
    if not (res and res.frames == frames - n_train
            and eval_counts['band_conv_fwd'] and eval_counts['roi_pool_fwd']):
        fail(f'the evaluation after training: {eval_counts}')
    return stats


def train_loader_tiny_parity(tmp, devices=('cpu', 'cuda')):
    """Phase 10b: the first two training-loader batches of a ``mini`` tree
    under the tiny training config, one step each on the CPU and on CUDA
    (``train_step_parity``, fresh trainers, the CPU's draws replayed on
    the card): losses within rtol 1e-4, gradients within 1e-3 x their
    scale (phase 7's tolerances)."""
    from virconv_tpu_torch.configs.tiny import tiny_train_config
    from virconv_tpu_torch.datasets import build_dataloader
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    root = write_tree(tmp / 'train_mini', 'mini', frames=5, seed=0,
                      n_train=4)
    cfg = tiny_train_config(root)
    _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2,
                                 seed=3, training=True)
    batches = [b for b, _ in loader][:2]
    out = []
    for i, batch in enumerate(batches):
        loss_rel, worst, losses = train_step_parity(cfg, batch, devices)
        out.append({'loss_rel_err': loss_rel, 'worst_grad': worst[0],
                    'worst_param': worst[1], 'losses': list(losses),
                    'gt_boxes': int(batch['gt_valid'].sum())})
        print(f'[phase 10] tiny config, loader batch {i}: loss '
              f'{losses[1]:.6g} vs {losses[0]:.6g} (rel err {loss_rel:.3g}, '
              f'tol 1e-4), worst gradient {worst[1]} at {worst[0]:.3g} x '
              f'its scale (tol 1e-3)', flush=True)
        if not (loss_rel <= 1e-4 and worst[0] <= 1e-3):
            fail(f'tiny config, loader batch {i}: devices disagree')
    if len(batches) != 2:
        fail(f'{len(batches)} loader batches, expected 2')
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print('FAIL: torch.cuda.is_available() is False', flush=True)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_grad_enabled(False)
    from virconv_tpu_torch.configs.tiny import tiny_config
    from virconv_tpu_torch.models.roi_heads import voxel_pool
    from virconv_tpu_torch.ops import (_cuda, band_conv, native, roi_pool,
                                       sparse)
    from virconv_tpu_torch.serve import Detector
    from virconv_tpu_torch.train.trainer import Trainer
    from virconv_tpu_torch.utils.bench_inputs import (FRAMES, synth_frames,
                                                      train_batch)

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else f'{kind}, power limit not reported'
    print(f'[info] torch {torch.__version__} cuda {torch.version.cuda} '
          f'card "{card}"', flush=True)

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.time()
    with ThreadPoolExecutor(len(_cuda.SOURCES) + 1) as pool:
        host = pool.submit(native.build)
        list(pool.map(_cuda.load, _cuda.SOURCES))
        host.result()
    print(f'[phase 1] built {len(_cuda.SOURCES)} kernel libraries and the '
          'native box library', flush=True)

    # ---- phase 2: every kernel call of one request vs its plain version ---
    t0 = phase_done(1, t0)
    det = Detector(device='cuda', seed=0)
    frames = synth_frames(FRAMES)
    with Capture() as cap:
        det.forward(frames)
        torch.cuda.synchronize()
    taps = {a[3].shape[0] for a in cap.band}
    pools = {(a[6], a[0].q_per_roi) for a in cap.pool}
    missing = ({27, 9, 3} - taps) | ({(8, 216), (8, 64), (4, 64)} - pools)
    if missing:
        fail(f'warm-up forward never reached {sorted(missing)} '
             '(band-conv taps / pool (stride, Q))')
    cases = {'band_conv_fwd': [], 'roi_pool_fwd': []}
    for i, a in enumerate(cap.band):
        line = check_band_case(f'{i:02d} {band_kind(a[0], a[2], a[3])}', a)
        cases['band_conv_fwd'].append(line)
        print(f'[phase 2] band_conv {short(line)}', flush=True)
    for i, a in enumerate(cap.pool):
        line = check_pool_case(
            f'{i} stride{a[6]}_q{a[0].q_per_roi}', a)
        cases['roi_pool_fwd'].append(line)
        print(f'[phase 2] roi_pool {short(line)}', flush=True)
    totals = {k: summed(v) for k, v in cases.items()}
    print(f'[phase 2] per request, summed over its calls: '
          f'{json.dumps(totals)}', flush=True)
    del cap

    # ---- phase 3: the main path --------------------------------------------
    t0 = phase_done(2, t0)
    band_conv.launches = roi_pool.launches = 0
    sparse.branch_counts.clear()
    voxel_pool.branch_counts.clear()
    times, dets = [], []
    for _ in range(N_REQUESTS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = det(frames)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        dets.append([len(r['scores']) for r in res])
        for r in res:
            if not (np.isfinite(r['boxes']).all()
                    and np.isfinite(r['scores']).all()):
                fail('non-finite detections')
    counts = {'band_conv_fwd': band_conv.launches,
              'roi_pool_fwd': roi_pool.launches}
    conv_branches = dict(sparse.branch_counts)
    pool_branches = dict(voxel_pool.branch_counts)
    raw = det.forward(frames)
    for k in ('batch_box_preds', 'batch_cls_preds'):
        if not bool(torch.isfinite(raw[k]).all()):
            fail(f'non-finite {k}')
    print(f'[phase 3] VirConv-T full width, {FRAMES} frames x ROT_NUM '
          f'{det.rot_num}, {N_REQUESTS} requests: ms/request '
          f'{times}, detections/frame {dets}, '
          f'launches {counts}, conv branches {conv_branches}, pool '
          f'branches {pool_branches} (over all {N_REQUESTS} requests)',
          flush=True)
    for k, v in counts.items():
        if v == 0:
            fail(f'{k} was never launched on the main path')
    del raw, det

    # ---- phase 4: tiny config, CUDA kernels vs CPU plain -------------------
    t0 = phase_done(3, t0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_config()
    tf = tiny_frames(np.random.default_rng(0))
    outs = {}
    for d in ('cuda', 'cpu'):
        tdet = Detector(cfg=cfg, device=d, seed=1, bf16=False)
        o = tdet.forward(tf)
        outs[d] = {k: o[k].detach().cpu() for k in
                   ('batch_box_preds', 'batch_cls_preds', 'roi_valid')}
    a, b = outs['cuda'], outs['cpu']
    box_err = float((a['batch_box_preds'] - b['batch_box_preds']).abs().max())
    cls_err = float((a['batch_cls_preds'] - b['batch_cls_preds']).abs().max())
    valid_same = bool(torch.equal(a['roi_valid'], b['roi_valid']))
    print(f'[phase 4] tiny config CUDA vs CPU: box max err {box_err:.3g} '
          f'(tol 5e-3), logit max err {cls_err:.3g} (tol 2e-3), roi_valid '
          f'identical {valid_same}', flush=True)
    if not (valid_same and box_err <= 5e-3 and cls_err <= 2e-3):
        fail('tiny config CUDA and CPU disagree')

    # ---- phase 5: every kernel call of one training step vs plain ---------
    # (training phases run f32 with TF32 off, as set for phase 4)
    t0 = phase_done(4, t0)
    with torch.enable_grad():
        trainer = Trainer(device='cuda', seed=0)
        batch = trainer.to_device(train_batch())
        train_cases = train_kernel_calls(trainer, batch)
        cases.update(train_cases)
        step_totals = {k: summed(v, 'step') for k, v in train_cases.items()}
        print(f'[phase 5] per training step, summed over its calls: '
              f'{json.dumps(step_totals)}', flush=True)

        # ---- phase 6: the main training path --------------------------------
        t0 = phase_done(5, t0)
        train_counts, train_run = train_steps(trainer, batch, N_TRAIN_STEPS)
        del trainer, batch

        # ---- phase 7: tiny config training step, CUDA vs CPU ----------------
        t0 = phase_done(6, t0)
        tiny_train_parity(('cpu', 'cuda'))

    # ---- phase 8: K5 and K6 on every submanifold conv of one request -------
    # (TF32 still off: the plain versions' f32 products are exact f32)
    t0 = phase_done(7, t0)
    gather_counts, gather_modes, gather_cases = gather_conv_phase(
        Detector(device='cuda', seed=0), frames)
    cases.update(gather_cases)
    gather_totals = {k: summed(v) for k, v in gather_cases.items()}
    for k, v in gather_totals.items():
        v['k1_ms'] = sum(c['k1_ms'] for c in gather_cases[k])
    misses = {a['case']: {'gather_conv_fwd': a['misses'],
                          'onehot_conv_fwd': b['misses']}
              for a, b, _ in zip(*gather_cases.values())}
    print(f'[phase 8] per request, summed over its 24 convs (k1_ms: K1 on '
          f'the same layers with the same operand type): '
          f'{json.dumps(gather_totals)}', flush=True)
    print(f'[phase 8] misses per layer: {json.dumps(misses)}', flush=True)

    # ---- phase 9: the evaluation path (loader, model, dicts, AP) ------------
    t0 = phase_done(8, t0)
    from virconv_tpu_torch.utils.common import create_logger
    logger = create_logger()
    with tempfile.TemporaryDirectory() as tmp:
        eval_run = eval_scene(Path(tmp), EVAL_FRAMES, FRAMES, logger)
        eval_run['tiny_cuda_vs_cpu'] = eval_tiny_parity(Path(tmp), logger)
    t0 = phase_done(9, t0)

    # ---- phase 10: training from a KITTI tree (loader, CLI, resume) ---------
    with tempfile.TemporaryDirectory() as tmp, torch.enable_grad():
        train_cli = train_cli_scene(Path(tmp), TRAIN_FRAMES, TRAIN_N_TRAIN,
                                    FRAMES)
        train_cli['tiny_cuda_vs_cpu'] = train_loader_tiny_parity(Path(tmp))
    phase_done(10, t0)

    # ---- result -------------------------------------------------------------
    src = 'virconv_tpu_torch/csrc/band_conv.cu'
    meta = {'band_conv_fwd': (src, 'virconv_tpu/ops/pallas/band_conv.py:139'),
            'roi_pool_fwd': ('virconv_tpu_torch/csrc/roi_pool.cu',
                             'virconv_tpu/ops/pallas/roi_pool.py:241+268'),
            'band_conv_dw': (src, 'virconv_tpu/ops/pallas/band_conv.py:188'),
            'gather_conv_fwd': ('virconv_tpu_torch/csrc/gather_conv.cu',
                                'virconv_tpu/ops/pallas/gather_conv.py:42'),
            'onehot_conv_fwd': ('virconv_tpu_torch/csrc/gather_conv.cu',
                                'virconv_tpu/ops/pallas/onehot_conv.py:40')}
    launches = {**counts, 'band_conv_dw': train_counts['band_conv_dw'],
                **gather_counts}
    totals['band_conv_dw'] = step_totals['band_conv_dw']
    totals.update(gather_totals)
    kernels = [{'name': name, 'route': 'cuda', 'source': s,
                'replaces': rep, 'launches': launches[name], **totals[name]}
               for name, (s, rep) in meta.items()]
    # K5 and K6 by mode; K6's numbers are its bf16 calls', f32 apart
    by_name = {k['name']: k for k in kernels}
    for name, modes in gather_modes.items():
        by_name[name]['launches_by_mode'] = modes
    by_name['onehot_conv_fwd']['f32'] = {
        'launches': sum(v for m, v in gather_modes['onehot_conv_fwd'].items()
                        if m.endswith('f32')),
        **totals['onehot_conv_fwd_f32']}
    # K1 in training: forward and input-gradient calls together, and apart
    k1_train = summed(train_cases['band_conv_fwd_train']
                      + train_cases['band_conv_fwd_train_dgrad'], 'step')
    kernels[0]['train'] = {
        'launches': train_counts['band_conv_fwd'], **k1_train,
        'forward': step_totals['band_conv_fwd_train'],
        'input_grad': step_totals['band_conv_fwd_train_dgrad']}
    for k in kernels[:2]:
        k['launches_eval'] = eval_run['launches'][k['name']]
    # phase 10: the training CLI's steps, and the evaluation after them
    per_step = train_cli['launches_per_step']
    kernels[0]['train']['launches_train_cli'] = sum(
        r['k1_forward'] + r['k1_input_grad'] for r in per_step)
    by_name['band_conv_dw']['launches_train_cli'] = sum(
        r['k4'] for r in per_step)
    for k in kernels[:2]:
        k['launches_train_cli_eval'] = train_cli['launches_eval'][k['name']]
    print(json.dumps({'kernels': kernels, 'train_step': train_run,
                      'eval': eval_run, 'train_cli': train_cli,
                      'cases': cases}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
