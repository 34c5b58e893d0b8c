#!/usr/bin/env python3
"""Drive the PyTorch port (virconv_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. build the CUDA kernels (one nvcc per source, in parallel) and the
     native host box library (g++);
  2. hold every kernel call of one full-width request against its plain
     PyTorch version on the same inputs (captured from a warm-up forward:
     every 3D submanifold, strided, 2D first-wins and conv_out layer, with
     the gather patch of each whose band windows do not all fit, which
     runs in K1's call; every stride-8 and stride-4 pool the kernel runs):
     f32 and bf16 operands, identical ROI selections, each patched call
     bit for bit against the composition it replaced (K1, ``nmap_conv``,
     the eager epilogue, an index put), kernel and plain times (the
     patch's: the joined call's less the same call's without it, beside
     the replaced composition's), each call's bound, and each kernel's
     sums over the request;
  3. serve 3 requests of FRAMES=2 synthetic KITTI-scale frames through the
     full-width VirConv-T Detector (ROT_NUM=3, seeded random weights), with
     every launch count set to 0 just before and read just after: K1 and
     the gather patches launched as often as in the warm-up, the NMS
     kernel pair twice a request, no conv context on the neighbor-map
     branch; then one more request under
     ``torch.profiler``, its kernel launches printed;
  4. the tiny test configuration on CUDA (kernels) and on the CPU (plain
     versions) with the same weights, TF32 off: final boxes and scores
     compared;
  5. every K1 call (forward, and input gradient with transposed weights),
     every gather patch, every K4 call and every pool gather
     (``gather_rows``, forward and backward) of one full-width VirConv-T
     training step
     (``Trainer.step(train_batch())``: 2 frames x ROT_NUM 3) against its
     plain version, f32 and bf16 operands; each K4 call run twice for
     identical bits and named by its CTA layout (chunks x taps x slabs);
     kernel and plain times with f32 operands, each call's bound at the
     f32 peak, and the sums per step (the gather's backward run twice
     for identical bits, its first two calls also against the CPU's
     sequential ``index_add_`` bit for bit, its CSR against the stable
     sort's; its CSR build, sums and hot-row tail timed apart and printed
     per step); and every neighbor-map training call (the strided and
     NRConv 2D convs): ``nmap_conv`` forward and input gradient against
     their plain versions and bit for bit against ``nmap_conv``'s previous
     body, ``nmap_conv_dw`` for each conv's weight gradient and each band
     conv's gather-patch term against its plain version and run twice for
     identical bits, kernel and plain times, bounds and sums per step;
  6. the main training path: 3 full-width steps with every launch count
     set to 0 just before and read just after: finite losses, no skipped
     step, K1, K4 and the gather's backward launched, no band training
     conv on the neighbor-map branch, every counter (K1, K4, ``nmap_conv``,
     ``nmap_conv_dw``, ``branch_counts['nmap_train']``) at phase 5's step's
     calls per step, 15 neighbor-map convs per step, the NMS kernel pair
     twice a step; ms per step, peak
     memory and each step's loss terms; (6b) one step's forward and
     backward twice from one trainer with the same draws: every
     parameter's gradient the same bits (the modules that differ are
     printed, with the ops PyTorch's deterministic mode flags);
  7. one training step of the tiny configuration on CUDA and on the CPU
     with the same weights and the same random draws (drawn once on the
     CPU), TF32 off (``tiny_train_parity``): every loss within rtol 1e-4;
     every gradient within 1e-3 x its scale with the ReLU kinks the two
     devices' round-off put on opposite sides, and the box-geometry
     outputs (RPN maps, regression heads), snapped to the CPU's values,
     gradients passed through (the moves gated at 1e-4 x scale, the
     kinks crossed and the unsnapped step's worst gradients printed);
     and within 1e-3 x scale with the box-regression outputs zeroed on
     both devices (``zero_box_outputs``);
  8. the windowed gather convs K5 (``fused_gather_conv``, f32, tile 512)
     and K6 (``onehot_gather_conv``, tile 256, block 2048, bf16 and f32
     operands), and ``nmap_conv`` (the neighbor-map branch's exact conv),
     on the neighbor maps of all 24 submanifold convs of one full-width
     request (captured from a warm-up forward), once each with every
     launch count set to 0 just before and read just after, each K5 and
     K6 call in the mode ``kernel_mode`` picks (row and tile modes both
     launched); then per conv: kernel vs plain (identical misses), and on
     the rows of tiles with no misses whose K1 tile fits, K1's raw output
     with the same operand type (f32: K5, K6 and ``nmap_conv`` bit for bit;
     bf16: within 1e-4, bit equality reported), ``nmap_conv`` bit for bit
     against its previous body (``nmap_conv_prev``), kernel, previous-body,
     plain and K1 times, the (fragment, tap) rows each body multiplies per
     hit, the bound; sums per request and misses per layer;
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
 11. VirConv-L and VirConv-S at full width (seeded weights): (a) every K1
     and K2+K3 call of one VirConv-L request (FRAMES=2 frames of one fused
     stream, no replica; all 20 sparse convs, 19 NRConv convs and
     conv_out, on K1, and their gather patches) and every K1 forward, K1
     input-gradient, gather-patch and K4 call of one training step
     (``train_batch_l``: 2 frames, one entry each) against their plain
     versions, as phases 2 and 5; the contexts whose non-fitting rows
     exceed the JAX package's patch cap (which sends them to its full
     neighbor map) timed on both routes; (b) 3 requests through
     ``serve.Detector(virconv_l_config())`` with every launch count set
     to 0 just before and read just after, gated as phase 3: ms and
     launches per request, the pools by route; (c) 3 training steps
     (finite losses, no skip, K1
     forward, K1 input gradient and K4 launched, the counters at 11a's
     step's calls, 12 neighbor-map convs per step; ms per step, peak
     memory), then (fault C4's gate, VirConv-T on phase 6's batch first)
     two fresh trainers from one seed take 3 steps each: every loss term,
     parameter and BN statistic the same bits after every step; (d) the
     tiny-L config CUDA vs CPU: evaluation as phase 4, one training step
     as phase 7 with the unsnapped step's gradients gated too; (e)
     ``eval_one_ckpt`` of a seeded VirConv-L checkpoint on phase 9's scene
     tree through the single-stream loader, gated as phase 9a; (f)
     ``tools/train_gpu.py --cfg virconv_s`` for one epoch of 2 steps on a
     ``scene`` tree of 2 train and 2 semi frames from phase 10's VirConv-T
     checkpoint as ``--pretrained_model``: frames from both ``training/``
     and ``semi/``, finite losses, K1 and K4 on every step;
 12. PENet virtual points at full width (seeded weights): (a) PENetC2 on
     the card; (b) every CSPN kernel launch (``csrc/cspn.cu``) of one
     352 x 1216 frame against its plain version (1e-4 x scale), kernel
     and plain times and the bound, and the frame's depth twice, the
     same bits; (c)
     ``tools/generate_virtual_points_gpu.py`` over a 4-frame ``scene``
     tree (375 x 1242 images) with the CSPN count set to 0 just before
     and read just after (12 per frame): each ``velodyne_depth`` file
     float16 with 8 columns, the scan first (indicator 2, intensity x
     10), then the virtual points (indicator 1, z < 1), every frame's
     made on the depth2points kernels; seconds per frame by stage and
     points per frame; (d) ``eval_one_ckpt`` of VirConv-T over the
     generated tree, gated as 9a; (f) the depth2points tail
     (``csrc/depth2points.cu``) on 4 street depths at the crop: numpy's
     cloud bit for bit, host and device ms a call, calls, the bound and
     numpy's ms; (e) PENetC2 at 64 x 96 on CUDA against the CPU, the
     depth within 1e-4 x scale;
 13. the JAX package's precision switches (K1 with bf16 features, K1
     and K4 with bf16 training operands, K2+K3 at f32 operands, the
     ODIoU step);
 14. data parallel (``parallel/``), 2 ranks sharing this card over gloo
     (NCCL refuses two ranks on one device; ``parallel.spawn.run_ranks``
     starts them): (a) one full-width VirConv-T step of phase 6's batch
     within the boxes of ``DP_CROP`` (where no capacity cap binds), a
     frame (3 entries) per rank, against the one-process ``Trainer`` step
     from the same weights with its draws mapped to the ranks and its NMS
     selections replayed on them (``replay_nms``), the box-regression
     outputs zeroed (``zero_box_outputs``): no proposal order or sampling
     threshold can then turn on round-off. Gates: the loss within rel
     1e-4, the parameters within 3 x the first learning rate + 1e-3 rel
     and the BN statistics within 2e-4 + 1e-2 rel
     (tests/test_multidevice.py's), every gradient within 1e-2 of its
     norm (the worst entry against phase 7's 1e-3 x its scale printed:
     round-off crosses ReLU kinks at full width, PERF.md §6), both
     ranks' parameters the same bits, a second 2-rank run the same bits,
     no capacity cap dropping a row, K1, K4 and the gather's backward
     launched on each rank (counts set to 0 before each rank's steps,
     read after); then on phase 6's whole batch, 3 steps of 2 ranks with
     their own draws: per-rank warm step ms against the one-process step,
     the gradient all-reduce's and the sync-BN all-reduces' calls, bytes
     and ms per step, peak memory per rank, and the rows each cap drops
     per rank; (b) one rank in an nccl group of its own, the same bits as
     the trainer without a group; (c) ``tools/test_gpu.py --launcher
     pytorch`` over phase 9's tree and checkpoint, rank 0's merged dicts
     against one process with per-frame streams (the same frames and
     counts, boxes within 5e-3, scores within 2e-3, AP within 1e-4); (d)
     ``tools/train_gpu.py --launcher pytorch`` for one epoch on phase
     10's tree: the same finite losses on both ranks, the checkpoint
     written by rank 0 alone, the distributed evaluation after training;
 15. the JAX package's six routing switches (``Switches``), f32 operands,
     TF32 off: VirConv-T on phase 3's request under its default route and
     under ``VIRCONV_BAND=0`` (every eval conv on ``nmap_conv``),
     ``VIRCONV_BAND2D=0``, ``VIRCONV_DENSE2D=1``, ``VIRCONV_POOL_KERNEL=0``
     and ``VIRCONV_POOL_TILE=1`` (K2+K3 quadrant-tiled below stride 8),
     VirConv-L under the first three: per route a captured forward gated
     against the default route's (every stream's coords and masks equal,
     features within 1e-4 x scale, ROI valid sets equal and boxes within
     1e-3, or matched ROI by ROI), every ``nmap_conv`` call and every
     tiled K2+K3 call against its plain version (``nmap_conv`` also bit for
     bit against its previous body), each tiled call un-tiled
     bit for bit against the untiled call, then 2 requests with every
     launch and branch count set to 0 just before and read just after: ms
     per request, launches, branch counts, peak memory; the dense LiDAR
     tail (``LidarStack(dense_tail=True)``) against the sparse stack on
     the request's LiDAR stream, at eval and one training forward and
     backward; a T training step's forward and backward under
     ``VIRCONV_BAND_TRAIN=0`` against the default's from the same state
     and draws;
 16. the multi-rank tools, every rank on this card (``multi_rank_phase``);
 17. the RPN's rotated NMS on the kernel pair of ``csrc/nms.cu``
     (``nms_phase``): the call of one full-width VirConv-T training step
     (6 entries at k = 4000) and of one request (2 at k = 2000), the
     launch count set to 0 just before the step or request and read just
     after (two each), the selections the call returned there against
     the plain ``nms_bev`` of every entry, the mask's bits (one more
     launch on the captured arguments) the plain suppression's; the
     call's ms, each kernel's device ms, the plain loop's ms and the
     bound;
then one JSON line of per-kernel numbers (the six kernels' ports, the
gather patch's (``band_conv_patch``), ``nmap_conv``'s (phase 8),
``gather_rows``' per training step, ``cspn``'s per frame and ``nms``'s
(phase 17) per step and request; times and
bounds per request, step or frame, summed over its calls; launches over
the phase 3 requests, the phase 6 steps, the phase 8 path and phase 12c,
K1's and K2+K3's over the phase 9a run as
``launches_eval``, and over phase 10a's steps and evaluation as
``launches_train_cli`` and ``launches_train_cli_eval``; VirConv-L's per
request and per step under ``virconv_l``) with phase 9's numbers under
``eval``, phase 10's under ``train_cli``, phase 11's under ``virconv_l``
and ``virconv_s``, phase 12's under ``virtual_points``, phase 13's under
``precision``, phase 14's under ``data_parallel``, phase 15's under
``routing`` (its kernel rows ``nmap_conv_fwd_eval`` and
``roi_pool_fwd_tiled`` per T request) and phase 16's under
``multi_rank``, the training neighbor-map conv's
rows ``nmap_conv_fwd_train`` and ``nmap_conv_dw`` per T step (phase 5's
calls, phase 6's launches; VirConv-L's per step under ``virconv_l``), the
card's
name and power limit, and the device JSON as the last line; phase 3's
launches per request under ``serve``. Each phase
prints its seconds. It needs the repository around it: alone, or without
a CUDA device, it exits non-zero and prints no result.
"""

import collections
import json
import math
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


def graph_ms(fn, reps=20):
    """The device time of one ``fn()``: ``reps`` calls captured in a CUDA
    graph and the graph replayed between CUDA events, so the host's work
    in the wrapper (checks, allocation, the ctypes call) is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='thread_local'):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bits_equal(got, want):
    """The same float32 bits (int32 views: -0 is not +0, a NaN equals
    itself)."""
    import torch
    return got.shape == want.shape and torch.equal(
        got.contiguous().view(torch.int32), want.contiguous().view(
            torch.int32))


def phase_done(n, t0):
    """Prints phase ``n``'s seconds since ``t0``; returns the time now."""
    now = time.time()
    print(f'[phase {n}] {now - t0:.1f} s', flush=True)
    return now


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


class Capture:
    """Records the inputs of every kernel call of one warm-up forward (the
    calls still launch the kernels): K1's with their gather patches, and
    the pools'."""

    def __init__(self):
        from virconv_tpu_torch.ops import band_conv, roi_pool
        self.band, self.pool = [], []
        # per call: K1's (operands bf16, output dtype), the pool's operands
        self.band_modes, self.pool_bf16 = [], []
        self._bc, self._rp = band_conv, roi_pool
        self._orig = (band_conv._band_conv_cuda, roi_pool._roi_pool_cuda)

    def __enter__(self):
        import torch
        orig_bc, orig_rp = self._orig

        def bc(feats, keys, plan, weights, scale, bias, relu, bf16,
               patch=None, out_dtype=torch.float32):
            self.band.append((feats, keys, plan, weights, scale, bias, relu,
                              patch))
            self.band_modes.append((bf16, out_dtype))
            return orig_bc(feats, keys, plan, weights, scale, bias, relu,
                           bf16, patch, out_dtype)

        def rp(plan, fg, w_eff, b_eff, specs, vs, stride, pcr, bf16,
               sel_out=None):
            self.pool.append((plan, fg, w_eff, b_eff, specs, vs, stride, pcr))
            self.pool_bf16.append(bf16)
            return orig_rp(plan, fg, w_eff, b_eff, specs, vs, stride, pcr,
                           bf16, sel_out)
        self._bc._band_conv_cuda, self._rp._roi_pool_cuda = bc, rp
        return self

    def __exit__(self, *exc):
        self._bc._band_conv_cuda, self._rp._roi_pool_cuda = self._orig
        return False


class TrainCapture:
    """Records the inputs of every K1 (with its gather patch) and K4 call of
    one training step, and of every neighbor-map training call
    (``nmap_conv``, ``nmap_conv_dw``); the calls still launch the kernels.
    K1 and ``nmap_conv`` calls made while the model's forward runs are the
    convs; those after it, in the backward, are the input-gradient passes.
    An ``nmap_conv_dw`` call made while ``sparse._BandTrain.backward`` runs
    is a band conv's gather-patch term, any other a neighbor-map conv's
    dW."""

    def __init__(self, model):
        from virconv_tpu_torch.ops import band_conv, nmap_conv, sparse
        self.fwd, self.dgrad, self.dw = [], [], []
        self.nmap_fwd, self.nmap_dgrad, self.nmap_dw = [], [], []
        self.patch_dw = []
        self.bf16 = []      # each K1 and K4 call's operand flag
        self._bc, self._nc, self._model = band_conv, nmap_conv, model
        self._band_train = sparse._BandTrain
        self._orig = (band_conv._band_conv_cuda,
                      band_conv._band_conv_dw_cuda,
                      nmap_conv._nmap_conv_cuda,
                      nmap_conv._nmap_conv_dw_cuda,
                      sparse._BandTrain.backward)
        self._in_forward = self._in_band_backward = False

    def __enter__(self):
        import torch
        orig_k1, orig_k4, orig_nm, orig_nm_dw, orig_band_bwd = self._orig
        forward = self._model.forward

        def model_forward(*a, **k):
            self._in_forward = True
            try:
                return forward(*a, **k)
            finally:
                self._in_forward = False

        def k1(feats, keys, plan, weights, scale, bias, relu, bf16,
               patch=None, out_dtype=torch.float32):
            calls = self.fwd if self._in_forward else self.dgrad
            calls.append((feats, keys, plan, weights, scale, bias, relu,
                          patch))
            self.bf16.append(bf16)
            return orig_k1(feats, keys, plan, weights, scale, bias, relu,
                           bf16, patch, out_dtype)

        def k4(feats, keys, plan, g, valid_bits, bf16):
            self.dw.append((feats, keys, plan, g, valid_bits))
            self.bf16.append(bf16)
            return orig_k4(feats, keys, plan, g, valid_bits, bf16)

        def nm(feats, nmap, weights):
            calls = self.nmap_fwd if self._in_forward else self.nmap_dgrad
            calls.append((feats, nmap, weights))
            return orig_nm(feats, nmap, weights)

        def nm_dw(feats, nmap, g):
            (self.patch_dw if self._in_band_backward else self.nmap_dw) \
                .append((feats, nmap, g))
            return orig_nm_dw(feats, nmap, g)

        def band_backward(ctx, g):
            self._in_band_backward = True
            try:
                return orig_band_bwd(ctx, g)
            finally:
                self._in_band_backward = False
        self._model.forward = model_forward
        self._bc._band_conv_cuda, self._bc._band_conv_dw_cuda = k1, k4
        self._nc._nmap_conv_cuda, self._nc._nmap_conv_dw_cuda = nm, nm_dw
        self._band_train.backward = staticmethod(band_backward)
        return self

    def __exit__(self, *exc):
        (self._bc._band_conv_cuda, self._bc._band_conv_dw_cuda,
         self._nc._nmap_conv_cuda, self._nc._nmap_conv_dw_cuda,
         band_bwd) = self._orig
        self._band_train.backward = staticmethod(band_bwd)
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


def old_patch_composition(args, bf16):
    """A band conv with its gather patch as it ran before the patch joined
    K1's call: K1, then ``nmap_conv`` over the patch map, the eager
    ``_epilogue`` and an index put."""
    from virconv_tpu_torch.ops import band_conv as bc
    from virconv_tpu_torch.ops import nmap_conv as nc
    from virconv_tpu_torch.ops.sparse import _epilogue
    feats, keys, plan, w, scale, bias, relu, (pidx, pnmap) = args
    out = bc.band_conv(feats, keys, plan, w, scale, bias, relu, bf16)
    out[pidx] = _epilogue(nc.nmap_conv(feats, pnmap, w), None, scale, bias,
                          relu)
    return out


def check_band_case(name, args, bf16_timed=True, peak=BF16_FLOPS):
    """One main-path band-conv call: kernel vs plain (f32 and bf16
    operands), both timed with the path's operands (bf16 at serve, f32 in
    training), and the call's bound at ``peak``; K1's numbers are those of
    the call without its gather patch. A call with a patch is also held
    bit for bit against the composition the joined call replaces
    (``old_patch_composition``), and its patch gets a line of its own
    under ``patch`` (``patch_case``)."""
    import torch
    from virconv_tpu_torch.ops import band_conv as bc
    feats, keys, plan, w, scale, bias, relu, patch = args
    line = {'case': name, 'rows_in': feats.shape[0], 'rows_out': plan.n_out,
            'c_in': w.shape[1], 'c_out': w.shape[2], 'taps': w.shape[0],
            'patch_rows': 0 if patch is None else patch[0].shape[0]}
    patch_err = 0.0
    for bf16 in (False, True):
        got = bc.band_conv(feats, keys, plan, w, scale, bias, relu, bf16,
                           patch)
        want = bc.band_conv_plain(feats, keys, plan, w, scale, bias, relu,
                                  bf16, patch)
        err = float((got - want).abs().max())
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        line[f'max_abs_err_{"bf16" if bf16 else "f32"}'] = err
        if not err <= tol:
            fail(f'band_conv {name} bf16={bf16}: max err {err} > {tol}')
        if patch is not None and not bf16:
            patch_err = float((got[patch[0]] - want[patch[0]]).abs().max())
        if patch is not None and not torch.equal(
                got, old_patch_composition(args, bf16)):
            fail(f'band_conv {name} bf16={bf16}: the joined patch differs '
                 'from K1 + nmap_conv + epilogue + index put')
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
    if patch is not None:
        line['patch'] = patch_case(name, args, bf16_timed, line['ms'],
                                   patch_err)
    return line


def patch_case(name, args, bf16, k1_ms, err):
    """The gather patch of one band-conv call: its time is the joined
    call's less ``k1_ms`` (the same call without the patch, on the same
    inputs); ``old_ms`` the same difference for the composition it
    replaced (``old_patch_composition``), timed in this run; plain: the
    plain patch (``nmap_conv_plain``, ``_epilogue``, an index put into
    K1's output), ``err`` its rows' error against it with f32 operands.
    Bound: the feature rows the map names, the map, index
    and weights read once, the patch rows written once; 2*C*C' operations
    per (row, tap) hit, at the f32 peak (f32 operands)."""
    import torch
    from virconv_tpu_torch.ops import band_conv as bc
    from virconv_tpu_torch.ops import nmap_conv as nc
    from virconv_tpu_torch.ops.sparse import _epilogue
    feats, keys, plan, w, scale, bias, relu, patch = args
    pidx, pnmap = patch
    out = bc.band_conv(feats, keys, plan, w, scale, bias, relu, bf16)

    def plain():
        out[pidx] = _epilogue(nc.nmap_conv_plain(feats, pnmap, w), None,
                              scale, bias, relu)
    line = {'case': name, 'rows': pidx.shape[0], 'rows_in': feats.shape[0],
            'c_in': w.shape[1], 'c_out': w.shape[2], 'taps': w.shape[0],
            'max_abs_err_f32': err}
    line['fused_ms'] = cuda_ms(lambda: bc.band_conv(
        feats, keys, plan, w, scale, bias, relu, bf16, patch))
    line['ms'] = line['fused_ms'] - k1_ms
    line['old_ms'] = cuda_ms(
        lambda: old_patch_composition(args, bf16)) - k1_ms
    line['plain_ms'] = cuda_ms(plain, reps=3, warmup=1)
    hit = pnmap[pnmap >= 0]
    line['taps_hit'] = int(hit.numel())
    line['bytes'] = (int(torch.unique(hit).numel()) * feats.shape[1] * 4
                     + nbytes(pnmap, pidx, w) + pidx.shape[0] * w.shape[2]
                     * 4)
    line['ops'] = 2.0 * line['taps_hit'] * w.shape[1] * w.shape[2]
    bound(line, F32_FLOPS)
    return line


def check_dw_case(name, args, bf16_timed=False, peak=F32_FLOPS):
    """One K4 call of the training step: kernel vs plain (f32 and bf16
    operands), two kernel runs with identical bits, both timed with the
    path's operands (f32; bf16 under ``VIRCONV_BAND_TRAIN_BF16``), and the
    call's bound at ``peak``."""
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
                                                 bf16_timed))
    line['plain_ms'] = cuda_ms(lambda: bc.band_conv_dw_plain(
        feats, keys, plan, g, vb, bf16_timed), reps=3, warmup=1)
    # bound: inputs read once + dW written once, and 2*C*C' operations per
    # valid (row, tap) that has a source in this run's data
    vb = plan.valid_bits if vb is None else vb
    hits = taps_hit(feats, keys, plan, vb, row_valid=True)
    line['taps_hit'] = hits
    line['bytes'] = (nbytes(feats, keys, plan.base_keys, vb, plan.blk, g)
                     + k * c_in * c_out * 4)
    line['ops'] = 2.0 * hits * c_in * c_out
    bound(line, peak)
    return line


def check_pool_case(name, args, bf16_timed=True):
    """One main-path ROI-pool call: identical selections, kernel vs plain
    (f32 and bf16 features), both timed with the path's operands (bf16;
    f32 under ``VIRCONV_POOL_BF16=0``), and the call's bound."""
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
        plan, fg, w_eff, b_eff, specs, vs, stride, pcr, bf16_timed))
    line['plain_ms'] = cuda_ms(lambda: rp.roi_pool_plain(
        plan, fg, w_eff, b_eff, specs, vs, stride, pcr, bf16_timed), reps=3,
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


class RowsCapture:
    """Records the inputs of every ``gather_rows`` kernel call, forward
    and backward, while it is entered (the calls still launch)."""

    def __init__(self):
        from virconv_tpu_torch.ops import gather_rows
        self.fwd, self.bwd = [], []
        self._gr = gather_rows
        self._orig = (gather_rows._gather_rows_cuda,
                      gather_rows._gather_rows_bwd_cuda)

    def __enter__(self):
        orig_f, orig_b = self._orig

        def fwd(feats, idx, valid):
            self.fwd.append((feats, idx, valid))
            return orig_f(feats, idx, valid)

        def bwd(g, idx, valid, n):
            self.bwd.append((g, idx, valid, n))
            return orig_b(g, idx, valid, n)
        self._gr._gather_rows_cuda, self._gr._gather_rows_bwd_cuda = fwd, bwd
        return self

    def __exit__(self, *exc):
        self._gr._gather_rows_cuda, self._gr._gather_rows_bwd_cuda = \
            self._orig
        return False


def check_rows_case(name, args, on_cpu):
    """One ``gather_rows`` call of the training step. Forward: the kernel
    equals ``index_select`` times the mask bit for bit (int32 views), its
    device time apart (``device_ms``, ``graph_ms``). Backward: two kernel
    runs give the same bits, the kernel is within 1e-4 x scale of the
    plain version on
    the same CUDA tensors (``index_add_``, atomics) and, with ``on_cpu``,
    equals it on the CPU bit for bit (a sequential ``index_add_``); its
    CSR equals the plain ``csr_of``'s (a stable sort) on the valid
    positions. Kernel, plain and library times (the library call:
    ``index_select``, or the ``index_add_`` of ``index_select``'s own
    backward), the backward's split (``csr_ms``: the CSR build; ``sum_ms``:
    the sums; ``sum_warp_rows_ms``: the sums with the long rows' CTAs given
    no row, so ``sum_ms`` less it is the hot-row tail; ``csr_sort_ms``: the
    plain ``csr_of`` on the card, the CSR build the kernel had before), and
    the bound: the inputs read and the output written once."""
    import torch
    from virconv_tpu_torch.ops import gather_rows as gr
    if len(args) == 3:
        feats, idx, valid = args
        line = {'case': name, 'rows': idx.shape[0], 'rows_in':
                feats.shape[0], 'c_in': feats.shape[1]}
        got = gr._gather_rows_cuda(feats, idx, valid)
        line['bit_equal'] = bits_equal(
            got, gr.gather_rows_plain(feats, idx, valid))
        if not line['bit_equal']:
            fail(f'gather_rows {name}: the forward differs from '
                 'index_select x mask in its bits')
        line['max_abs_err_f32'] = 0.0
        line['ms'] = cuda_ms(lambda: gr._gather_rows_cuda(feats, idx, valid))
        line['device_ms'] = graph_ms(
            lambda: gr._gather_rows_cuda(feats, idx, valid), reps=10)
        line['plain_ms'] = cuda_ms(
            lambda: gr.gather_rows_plain(feats, idx, valid))
        line['library_ms'] = cuda_ms(lambda: feats.index_select(0, idx))
        line['bytes'] = (nbytes(feats, idx, valid)
                         + idx.shape[0] * feats.shape[1] * 4)
        line['ops'] = float(idx.shape[0] * feats.shape[1])
    else:
        g, idx, valid, n = args
        hot = torch.bincount(idx[valid], minlength=1)
        line = {'case': name, 'rows': idx.shape[0], 'rows_out': n,
                'c_in': g.shape[1], 'valid_rows': int(valid.sum()),
                'max_rows_per_source': int(hot.max())}
        got = gr._gather_rows_bwd_cuda(g, idx, valid, n)
        line['bitwise_repeatable'] = torch.equal(
            got, gr._gather_rows_bwd_cuda(g, idx, valid, n))
        if not line['bitwise_repeatable']:
            fail(f'gather_rows backward {name}: two runs differ')
        scratch = gr._csr_cuda(idx, valid, n)
        order, offsets = gr.csr_views(scratch, n)
        p_order, p_offsets = gr.csr_of(idx, valid, n)
        n_valid = int(p_offsets[-1])
        line['csr_equal'] = (
            torch.equal(offsets.long(), p_offsets)
            and torch.equal(order[:n_valid].long(), p_order[:n_valid]))
        if not line['csr_equal']:
            fail(f'gather_rows backward {name}: the CSR differs from the '
                 'stable sort\'s')
        line['long_rows'] = int((offsets[1:] - offsets[:-1] > 256).sum())
        want = gr.gather_rows_bwd_plain(g, idx, valid, n)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        tol = 1e-4 * max(1.0, float(want.abs().max()) if want.numel()
                         else 0.0)
        line['max_abs_err_f32'] = err
        if not err <= tol:
            fail(f'gather_rows backward {name}: max err {err} > {tol}')
        if on_cpu:
            line['equal_to_cpu_index_add'] = torch.equal(
                got.cpu(), gr.gather_rows_bwd_plain(g.cpu(), idx.cpu(),
                                                    valid.cpu(), n))
            if not line['equal_to_cpu_index_add']:
                fail(f'gather_rows backward {name}: not the bits of the '
                     'CPU index_add_')
        line['ms'] = cuda_ms(
            lambda: gr._gather_rows_bwd_cuda(g, idx, valid, n))
        line['csr_ms'] = cuda_ms(lambda: gr._csr_cuda(idx, valid, n))
        line['sum_ms'] = cuda_ms(lambda: gr._rows_sum_cuda(g, scratch, n))
        no_long = scratch.clone()
        no_long[3 * n + 1] = 0          # the long rows' count (Csr.n_long)
        line['sum_warp_rows_ms'] = cuda_ms(
            lambda: gr._rows_sum_cuda(g, no_long, n))
        line['csr_sort_ms'] = cuda_ms(lambda: gr.csr_of(idx, valid, n))
        line['plain_ms'] = cuda_ms(
            lambda: gr.gather_rows_bwd_plain(g, idx, valid, n))
        line['library_ms'] = cuda_ms(
            lambda: g.new_zeros((n, g.shape[1])).index_add_(0, idx, g))
        line['bytes'] = nbytes(g, idx, valid) + n * g.shape[1] * 4
        line['ops'] = float(g.numel())
    library = line['library_ms']
    bound(line, F32_FLOPS)
    line['library_ms'] = library
    return line


class SubmCapture:
    """Records every ``sparse.subm_conv_ctx`` call of one forward (its
    sorted tensor, kernel size and whether duplicate keys take first-wins
    sources, in ``contexts``; the conv function, in ``fns``) and the
    (feats, weights) of each conv made on it (its epilogue arguments in
    ``epilogues``); the convs still run."""

    def __init__(self):
        from virconv_tpu_torch.ops import sparse
        self.contexts, self.fns, self.convs, self.epilogues = [], [], [], []
        self._sp, self._orig = sparse, sparse.subm_conv_ctx

    def __enter__(self):
        orig = self._orig

        def ctx(st, kernel_size, *a, **kw):
            conv = orig(st, kernel_size, *a, **kw)
            i = len(self.contexts)
            self.contexts.append(
                (st, kernel_size, kw.get('first_wins_sources', False)))
            self.fns.append(conv)

            def recorded(feats, weights, *ca, **ckw):
                self.convs.append((i, feats, weights.detach()))
                self.epilogues.append((ca, ckw))
                return conv(feats, weights, *ca, **ckw)
            return recorded
        self._sp.subm_conv_ctx = ctx
        return self

    def __exit__(self, *exc):
        self._sp.subm_conv_ctx = self._orig
        return False


# The JAX package's static gather patch (virconv_tpu/ops/sparse.py:758-764):
# a submanifold context with more non-fitting rows than
# max(JAX_PATCH_CAP, rows // JAX_PATCH_FRACTION) takes its full
# neighbor-map branch there.
JAX_PATCH_CAP, JAX_PATCH_FRACTION = 2048, 64


def sized_patch_contexts(det, frames, tag):
    """Phase 11a: the submanifold contexts of one request of ``det`` whose
    non-fitting rows exceed the JAX package's patch cap. Each of their
    convs is timed on the port's route (K1 with bf16 operands, then the
    sized gather patch in the same call) and on the JAX package's branch
    for such a context (the full neighbor map, built once per context, and
    the plain gathered conv in f32), and the route with f32 operands is
    held against that branch (1e-4 x the output scale). Returns a line
    per context."""
    import torch
    from virconv_tpu_torch.ops import sparse as sp
    with SubmCapture() as cap:
        det.forward(frames)
        torch.cuda.synchronize()

    def epilogue(scale=None, bias=None, relu=False):
        return scale, bias, relu
    lines = []
    for i, (st, ks, first_wins) in enumerate(cap.contexts):
        plan, keys = sp.subm_band_plan(st, ks)
        n_bad = int(sp._band_patch(plan, lambda qk: sp.lookup(keys, qk),
                                   patch_cap=0)[3])
        jax_cap = max(JAX_PATCH_CAP, plan.n_out // JAX_PATCH_FRACTION)
        if n_bad <= jax_cap:
            continue
        convs = [(f, w, epilogue(*ca, **ckw)) for (c, f, w), (ca, ckw) in
                 zip(cap.convs, cap.epilogues) if c == i]
        f32 = sp.subm_conv_ctx(st, ks, first_wins_sources=first_wins,
                               bf16=False)
        nmap = sp.build_subm_neighbor_map(st, ks)
        line = {'case': f'ctx{i:02d} k{convs[0][1].shape[0]}',
                'rows': plan.n_out, 'patch_rows': n_bad, 'jax_cap': jax_cap,
                'convs': len(convs),
                'ctx_ms': cuda_ms(lambda: sp.subm_conv_ctx(
                    st, ks, first_wins_sources=first_wins), reps=5,
                    warmup=1),
                'map_ms': cuda_ms(lambda: sp.build_subm_neighbor_map(st, ks),
                                  reps=5, warmup=1),
                'ms': 0.0, 'jax_branch_ms': 0.0, 'max_abs_err_f32': 0.0}
        for feats, w, epi in convs:
            src = feats
            if first_wins:
                is_first = torch.ones_like(keys, dtype=torch.bool)
                is_first[1:] = keys[1:] != keys[:-1]
                src = torch.where((st.mask & is_first)[:, None], feats,
                                  torch.zeros_like(feats))

            def branch():
                return sp._epilogue(sp.gathered_conv(src, nmap, w, st.mask),
                                    st.mask, *epi)
            want = branch()
            err = float((f32(feats, w, *epi) - want).abs().max())
            tol = 1e-4 * max(1.0, float(want.abs().max()))
            if not err <= tol:
                fail(f'{line["case"]}: the sized patch route is {err} off '
                     f'the neighbor-map conv (tol {tol})')
            line['max_abs_err_f32'] = max(line['max_abs_err_f32'], err)
            line['ms'] += cuda_ms(lambda: cap.fns[i](feats, w, *epi))
            line['jax_branch_ms'] += cuda_ms(branch, reps=5, warmup=1)
        line['jax_branch_ms'] += line['map_ms']
        lines.append(line)
        print(f'[{tag}] context past the JAX patch cap: {json.dumps(line)}',
              flush=True)
    return lines


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


def check_gather_case(lay, k5, k6, k6f, knm):
    """One submanifold conv through K5 (f32, tile 512), K6 (tile 256,
    block 2048; bf16 and f32 operands) and ``nmap_conv`` (the neighbor-map
    branch's exact conv), given the path's outputs ``k5``, ``k6`` (K6
    bf16), ``k6f`` (K6 f32) and ``knm``: each against its plain version
    and K1 with the same operand type (f32: bit for bit); times of the
    kernels, of their plain versions and of K1; each call's bound (K6 bf16
    at the bf16 peak, f32 calls at the f32 peak).
    Returns (K5 line, K6 bf16 line, K6 f32 line, nmap_conv line)."""
    import torch
    from virconv_tpu_torch.ops import band_conv as bc
    from virconv_tpu_torch.ops import gather_conv as gc
    from virconv_tpu_torch.ops import nmap_conv as nc
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
    lnm = dict(common)
    none = torch.zeros((1,), dtype=torch.int32, device=src.device)
    missnm = check_windowed(lnm, 'f32', (knm, none),
                            (nc.nmap_conv_plain(src, nmap, w), none),
                            k1[False], fits, n, exact=True)
    # the redesigned nmap_conv against its previous body, bit for bit
    if not bits_equal(knm, nc.nmap_conv_prev(src, nmap, w)):
        fail(f'{lay["case"]} nmap_conv: the redesigned body differs from '
             'the previous one')
    lnm['bit_equal_prev'] = True
    if lnm['mode'] == 'tile':
        lnm['prev_rows_per_hit'], lnm['rows_per_hit'] = \
            fragment_products(nmap)
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
    lnm['ms'] = cuda_ms(lambda: nc.nmap_conv(src, nmap, w))
    lnm['prev_ms'] = cuda_ms(lambda: nc.nmap_conv_prev(src, nmap, w))
    lnm['plain_ms'] = cuda_ms(lambda: nc.nmap_conv_plain(src, nmap, w),
                              reps=3, warmup=1)
    lnm['k1_ms'] = l5['k1_ms']
    # bound: features, map and weights read once, output and misses
    # written once; 2*C*C' operations per in-window (row, tap) hit, at the
    # f32 peak for f32 operands and the bf16 peak for K6's bf16 ones
    for line, f, m, miss, peak in ((l5, src5, nmap5, miss5, F32_FLOPS),
                                   (l6, src, nmap, miss6, BF16_FLOPS),
                                   (l6f, src, nmap, miss6f, F32_FLOPS),
                                   (lnm, src, nmap, missnm, F32_FLOPS)):
        line['misses'] = int(miss.sum())
        line['taps_hit'] = valid - line['misses']
        line['bytes'] = (nbytes(f, m, w, miss)
                         + f.shape[0] * c_out * 4)
        line['ops'] = 2.0 * line['taps_hit'] * c_in * c_out
        bound(line, peak)
    return l5, l6, l6f, lnm


def gather_conv_phase(det, frames):
    """Phase 8: K5, K6 and ``nmap_conv`` over the neighbor maps of every
    submanifold conv of one request (captured from a warm-up forward of
    ``det``). The path (``fused_gather_conv`` once per conv with its
    defaults, ``onehot_gather_conv`` twice, with its bf16 default and with
    f32 operands, and ``nmap_conv``, the conv a context with unsorted keys
    takes) runs with every launch count set to 0 just before and read just
    after; each K5 and K6 call must have run in the mode ``kernel_mode``
    picks. Then every call is checked and timed. Returns (counts, K5's and
    K6's launches by mode, per-call lines by kernel)."""
    import collections
    import torch
    from virconv_tpu_torch.ops import gather_conv as gc
    from virconv_tpu_torch.ops import nmap_conv as nc
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
    gc.launches = oc.launches = nc.launches = 0
    gc.mode_launches.clear()
    oc.mode_launches.clear()
    outs = [(gc.fused_gather_conv(lay['src5'], lay['nmap5'], lay['w']),
             oc.onehot_gather_conv(lay['src'], lay['nmap'], lay['w']),
             oc.onehot_gather_conv(lay['src'], lay['nmap'], lay['w'],
                                   bf16=False),
             nc.nmap_conv(lay['src'], lay['nmap'], lay['w']))
            for lay in layers]
    torch.cuda.synchronize()
    counts = {'gather_conv_fwd': gc.launches,
              'onehot_conv_fwd': oc.launches, 'nmap_conv_fwd': nc.launches}
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
    if counts['nmap_conv_fwd'] != len(layers):
        fail(f'{counts["nmap_conv_fwd"]} nmap_conv launches for '
             f'{len(layers)} convs')
    cases = {'gather_conv_fwd': [], 'onehot_conv_fwd': [],
             'onehot_conv_fwd_f32': [], 'nmap_conv_fwd': []}
    for lay, (k5, k6, k6f, knm) in zip(layers, outs):
        lines = check_gather_case(lay, k5, k6, k6f, knm)
        for (name, calls), line in zip(cases.items(), lines):
            calls.append(line)
            print(f'[phase 8] {name} {short(line)}', flush=True)
    equal = sum(c['k1_bit_equal_bf16'] for c in cases['onehot_conv_fwd'])
    print(f'[phase 8] on zero-miss fitting rows K5, K6 f32 and nmap_conv '
          f'equal K1 f32 bit for bit on all 24 convs; K6 bf16 equals K1 '
          f'bf16 bit for bit on {equal} of 24; nmap_conv equals its '
          f'previous body bit for bit on all 24', flush=True)
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
    device = {k: sum(c[k] for c in lines) for k in ('device_ms', 'prev_ms')
              if lines and all(k in c for c in lines)}
    return {f'launches_per_{unit}': len(lines), **device,
            'max_abs_err': max((v for c in lines for k, v in c.items()
                                if k.startswith('max_abs_err')),
                               default=None),
            'ms': sum(c['ms'] for c in lines),
            'plain_ms': sum(c['plain_ms'] for c in lines),
            'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
            'library_ms': sum(c['library_ms'] for c in lines)
            if lines and all(c.get('library_ms') is not None for c in lines)
            else None}


def patch_totals(lines, unit='request'):
    """``summed`` for the gather patches' lines, with the joined calls'
    times and the times of the composition they replaced."""
    return {**summed(lines, unit),
            'fused_ms': sum(c['fused_ms'] for c in lines),
            'old_ms': sum(c['old_ms'] for c in lines)}


def per_launch(lines, key, tag, label):
    """Prints one kernel's time per launch (CUDA events around the wrapper,
    and the device time alone) beside its bound, the range over the calls
    of each value of ``key``."""
    groups = {}
    for c in lines:
        groups.setdefault(c[key], []).append(c)
    for k, cs in groups.items():
        span = {f: f'{min(c[f] for c in cs):.4f}-{max(c[f] for c in cs):.4f}'
                for f in ('ms', 'device_ms', 'bound_ms')}
        print(f'[{tag}] {label} {key} {k}: {len(cs)} launches, ms per '
              f'launch {span["ms"]} (device {span["device_ms"]}), bound '
              f'{span["bound_ms"]}', flush=True)


def short(line):
    keep = ('case', 'stage', 'dilation', 'rows_in', 'rows_out', 'rows',
            'c_in', 'c_out', 'taps', 'layout', 'mode', 'rois',
            'queries_per_roi', 'stride',
            'selected', 'misses', 'max_abs_err_f32', 'max_abs_err_bf16',
            'k1_err_f32', 'k1_err_bf16', 'k1_bit_equal_f32',
            'k1_bit_equal_bf16', 'bitwise_repeatable', 'bit_equal',
            'bit_equal_prev', 'prev_rows_per_hit', 'rows_per_hit',
            'equal_to_cpu_index_add', 'max_rows_per_source', 'long_rows',
            'csr_equal', 'patch_rows', 'ms', 'device_ms', 'fused_ms',
            'old_ms', 'prev_ms', 'csr_ms',
            'sum_ms', 'sum_warp_rows_ms', 'csr_sort_ms', 'plain_ms',
            'library_ms', 'k1_ms', 'bound_ms', 'bound_by')
    return json.dumps({k: line[k] for k in keep if k in line})


def tiny_frames(rng, frames=2, n_pts=1500):
    """Frames of the tiny configs: ``tiny_batch``'s points and cameras."""
    from virconv_tpu_torch.utils.bench_inputs import tiny_batch
    batch = tiny_batch(rng, n_entries=frames, n_pts=n_pts)
    return {k: batch[k] for k in ('points', 'points_valid', 'points_mm',
                                  'points_mm_valid', 'v2r', 'p2t')}


def tiny_train_batch(rng, frames=2):
    """tiny_frames() with two gt cars per frame and a world transform per
    entry (each entry is its own sample): ``tiny_batch(train=True)``."""
    from virconv_tpu_torch.utils.bench_inputs import tiny_batch
    return tiny_batch(rng, n_entries=frames, train=True)


def request_kernel_calls(det, frames, tag='phase 2'):
    """Phase 2 (and 11a): every K1 call (with its gather patch) and K2+K3
    call of one request of ``det``, captured from a warm-up forward, held
    against its plain version (``check_band_case``, ``check_pool_case``).
    Returns (per-call lines by kernel, the band convs' tap counts, the
    pools' (stride, Q))."""
    import torch
    with Capture() as cap:
        det.forward(frames)
        torch.cuda.synchronize()
    taps = {a[3].shape[0] for a in cap.band}
    pools = {(a[6], a[0].q_per_roi) for a in cap.pool}
    cases = {'band_conv_fwd': [], 'band_conv_patch': [], 'roi_pool_fwd': []}
    for i, a in enumerate(cap.band):
        line = check_band_case(f'{i:02d} {band_kind(a[0], a[2], a[3])}', a)
        cases['band_conv_fwd'].append(line)
        print(f'[{tag}] band_conv {short(line)}', flush=True)
        if 'patch' in line:
            cases['band_conv_patch'].append(line.pop('patch'))
            print(f'[{tag}] band_conv patch '
                  f'{short(cases["band_conv_patch"][-1])}', flush=True)
    for i, a in enumerate(cap.pool):
        line = check_pool_case(
            f'{i} stride{a[6]}_q{a[0].q_per_roi}', a)
        cases['roi_pool_fwd'].append(line)
        print(f'[{tag}] roi_pool {short(line)}', flush=True)
    return cases, taps, pools


def serve_requests(det, frames, n_requests, model, per_request,
                   tag='phase 3'):
    """Phase 3 (and 11b), the serving path: ``n_requests`` requests of
    ``det`` with every launch count set to 0 just before and read just
    after; finite detections and raw outputs, K1 and K2+K3 launched, K1
    and the gather patches launched ``per_request`` times per request
    (the warm-up's calls), no conv context on the neighbor-map branch.
    Then one more request under ``torch.profiler``: its kernel launches
    (``profile_serve.summarize``). Returns (launch counts, the run's
    numbers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from virconv_tpu_torch.models.roi_heads import voxel_pool
    from virconv_tpu_torch.ops import band_conv, nmap_conv, roi_pool, sparse
    from virconv_tpu_torch.ops import boxes as box_ops
    from virconv_tpu_torch.profile_serve import summarize
    band_conv.launches = band_conv.patch_launches = roi_pool.launches = 0
    nmap_conv.launches = box_ops.nms_launches = 0
    sparse.branch_counts.clear()
    voxel_pool.branch_counts.clear()
    times, dets = [], []
    for _ in range(n_requests):
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
              'roi_pool_fwd': roi_pool.launches,
              'band_conv_patch': band_conv.patch_launches,
              'nmap_conv_fwd': nmap_conv.launches,
              'nms': box_ops.nms_launches}
    conv_branches = dict(sparse.branch_counts)
    pool_branches = dict(voxel_pool.branch_counts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        det(frames)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            traced = summarize(json.load(f), traced_ms)
    raw = det.forward(frames)
    for k in ('batch_box_preds', 'batch_cls_preds'):
        if not bool(torch.isfinite(raw[k]).all()):
            fail(f'non-finite {k}')
    print(f'[{tag}] {model} full width, {frames["points"].shape[0]} frames '
          f'x ROT_NUM '
          f'{det.rot_num}, {n_requests} requests: ms/request '
          f'{times}, detections/frame {dets}, '
          f'launches {counts}, conv branches {conv_branches}, pool '
          f'branches {pool_branches} (over all {n_requests} requests)',
          flush=True)
    print(f'[{tag}] one more request under torch.profiler: '
          f'{traced["kernel_launches"]} kernel launches per request, wall '
          f'{traced_ms:.1f} ms, device busy {traced["device_busy_ms"]:.1f} '
          f'ms', flush=True)
    for k in ('band_conv_fwd', 'roi_pool_fwd'):
        if counts[k] == 0:
            fail(f'{k} was never launched on the main path')
    if counts['nms'] != 2 * n_requests:
        fail(f'{counts["nms"]} NMS launches over {n_requests} requests, '
             'not 2 a request')
    for k in ('band_conv_fwd', 'band_conv_patch'):
        if counts[k] != per_request[k] * n_requests:
            fail(f'{counts[k]} {k} launches over {n_requests} requests, '
                 f'{per_request[k]} per request in the warm-up')
    if conv_branches.get('nmap_slow', 0) or counts['nmap_conv_fwd']:
        fail(f'a conv context left the band kernel: {conv_branches}')
    return counts, {'ms_per_request': times, 'detections_per_frame': dets,
                    'conv_branches': conv_branches,
                    'pool_branches': pool_branches,
                    'kernel_launches_per_request':
                    traced['kernel_launches'],
                    'traced_request': {k: traced[k] for k in (
                        'request_wall_ms', 'device_busy_ms',
                        'device_busy_share')}}


def tiny_serve_parity(cfg, frames=None, tag='phase 4'):
    """Phase 4 (and 11d): a tiny configuration on CUDA (kernels) and on the
    CPU (plain versions) with the same weights, f32 operands: roi validity
    identical, boxes within 5e-3, logits within 2e-3. Returns the
    errors."""
    import torch
    from virconv_tpu_torch.serve import Detector
    tf = tiny_frames(np.random.default_rng(0)) if frames is None else frames
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
    print(f'[{tag}] tiny config CUDA vs CPU: box max err {box_err:.3g} '
          f'(tol 5e-3), logit max err {cls_err:.3g} (tol 2e-3), roi_valid '
          f'identical {valid_same}', flush=True)
    if not (valid_same and box_err <= 5e-3 and cls_err <= 2e-3):
        fail('tiny config CUDA and CPU disagree')
    return {'box_max_err': box_err, 'logit_max_err': cls_err}


def train_kernel_calls(trainer, batch, tag='phase 5'):
    """Phase 5 (and 11a): one training step under TrainCapture, every
    captured call checked and timed. Returns the per-call lines by
    kernel."""
    import torch
    cap = TrainCapture(trainer.model)
    with cap, RowsCapture() as rows:
        trainer.step(batch)
    torch.cuda.synchronize()
    n_patched = sum(a[7] is not None for a in cap.fwd + cap.dgrad)
    taps = collections.Counter(a[2].shape[0] for a in cap.nmap_fwd)
    print(f'[{tag}] one training step: {len(cap.fwd)} K1 forward, '
          f'{len(cap.dgrad)} K1 input-gradient ({n_patched} with a gather '
          f'patch), {len(cap.dw)} K4, {len(rows.fwd)} + '
          f'{len(rows.bwd)} gather_rows calls; neighbor-map convs: '
          f'{len(cap.nmap_fwd)} nmap_conv forward (taps: '
          f'{dict(sorted(taps.items()))}), {len(cap.nmap_dgrad)} nmap_conv '
          f'input-gradient, {len(cap.nmap_dw)} nmap_conv_dw, '
          f'{len(cap.patch_dw)} nmap_conv_dw gather-patch terms', flush=True)
    if not (cap.fwd and cap.dgrad and cap.dw and rows.fwd and rows.bwd
            and cap.nmap_fwd and cap.nmap_dgrad and cap.nmap_dw):
        fail('the training step missed a kernel use')
    cases = {'band_conv_fwd_train': [], 'band_conv_fwd_train_dgrad': [],
             'band_conv_dw': [], 'band_conv_patch_train': [],
             'gather_rows_fwd': [], 'gather_rows_bwd': [],
             'nmap_conv_fwd_train': [], 'nmap_conv_fwd_train_dgrad': [],
             'nmap_conv_dw': [], 'nmap_conv_dw_patch': []}
    with torch.no_grad():
        for key, calls in (('band_conv_fwd_train', cap.fwd),
                           ('band_conv_fwd_train_dgrad', cap.dgrad)):
            for i, a in enumerate(calls):
                line = check_band_case(
                    f'{i:02d} {band_kind(a[0], a[2], a[3])}', a,
                    bf16_timed=False, peak=F32_FLOPS)
                cases[key].append(line)
                print(f'[{tag}] {key} {short(line)}', flush=True)
                if 'patch' in line:
                    cases['band_conv_patch_train'].append(line.pop('patch'))
                    print(f'[{tag}] {key} patch '
                          f'{short(cases["band_conv_patch_train"][-1])}',
                          flush=True)
        for i, a in enumerate(cap.dw):
            line = check_dw_case(f'{i:02d} k{len(a[2].deltas)}', a)
            cases['band_conv_dw'].append(line)
            print(f'[{tag}] band_conv_dw {short(line)}', flush=True)
        # the pool gathers (ops/gather_rows): the first two backward calls
        # are also held against the CPU's index_add_, bit for bit
        for key, calls in (('gather_rows_fwd', rows.fwd),
                           ('gather_rows_bwd', rows.bwd)):
            for i, a in enumerate(calls):
                line = check_rows_case(f'{i:02d}', a, on_cpu=i < 2)
                cases[key].append(line)
                print(f'[{tag}] {key} {short(line)}', flush=True)
        del rows
        # the neighbor-map training convs: forward and input gradient on
        # nmap_conv (also against its previous body), the weight gradients
        # and the band convs' gather-patch terms on nmap_conv_dw
        for key, calls in (('nmap_conv_fwd_train', cap.nmap_fwd),
                           ('nmap_conv_fwd_train_dgrad', cap.nmap_dgrad)):
            for i, a in enumerate(calls):
                line = check_nmap_case(f'{i:02d} k{a[2].shape[0]}', a, tag)
                cases[key].append(line)
                print(f'[{tag}] {key} {short(line)}', flush=True)
        for key, calls in (('nmap_conv_dw', cap.nmap_dw),
                           ('nmap_conv_dw_patch', cap.patch_dw)):
            for i, a in enumerate(calls):
                line = check_nmap_dw_case(f'{i:02d} k{a[1].shape[1]}', a)
                cases[key].append(line)
                print(f'[{tag}] {key} {short(line)}', flush=True)
        del cap
    return cases


def per_step_launches(cases):
    """The launches of one training step by counter that do not depend on
    its voxels, from the calls phase 5 (or 11a) captured: K1 (forward and
    input gradient), K4, ``nmap_conv`` (forward and input gradient), and
    the neighbor-map convs (``branch_counts['nmap_train']``)."""
    n = {k: len(v) for k, v in cases.items()}
    return {'band_conv_fwd': n['band_conv_fwd_train']
            + n['band_conv_fwd_train_dgrad'],
            'band_conv_dw': n['band_conv_dw'],
            'nmap_conv_fwd': n['nmap_conv_fwd_train']
            + n['nmap_conv_fwd_train_dgrad'],
            'nmap_train': n['nmap_conv_fwd_train']}


def check_nmap_dw_case(name, args):
    """One ``nmap_conv_dw`` call of the training step: kernel vs plain
    (1e-4 x max(1, scale)), two kernel runs with identical bits, kernel and
    plain times, and the bound: feats, map and g read once, dW written
    once, 2 C C' operations per (row, tap) hit at the f32 peak."""
    from virconv_tpu_torch.ops import band_conv as bc
    from virconv_tpu_torch.ops import nmap_conv as nc
    feats, nmap, g = args
    (n_out, k), c_in, c_out = nmap.shape, feats.shape[1], g.shape[1]
    got = nc.nmap_conv_dw(feats, nmap, g)
    if not bits_equal(got, nc.nmap_conv_dw(feats, nmap, g)):
        fail(f'nmap_conv_dw {name}: two runs differ')
    want = nc.nmap_conv_dw_plain(feats, nmap, g)
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    if not err <= tol:
        fail(f'nmap_conv_dw {name}: max err {err} > {tol}')
    chunk = nc.dw_chunk_rows(n_out, k, c_out)
    hits = int((nmap >= 0).sum())
    line = {'case': name, 'rows_in': feats.shape[0], 'rows_out': n_out,
            'c_in': c_in, 'c_out': c_out, 'taps': k,
            'layout': f'{-(-n_out // chunk)} chunks of {chunk} rows x {k} '
                      f'taps x {-(-c_out // bc.DW_MAX_SLAB)} slab(s)',
            'max_abs_err_f32': err, 'bitwise_repeatable': True,
            'ms': cuda_ms(lambda: nc.nmap_conv_dw(feats, nmap, g)),
            'plain_ms': cuda_ms(lambda: nc.nmap_conv_dw_plain(feats, nmap, g),
                                reps=3, warmup=1),
            'taps_hit': hits,
            'bytes': nbytes(feats, nmap, g) + k * c_in * c_out * 4,
            'ops': 2.0 * hits * c_in * c_out}
    bound(line, F32_FLOPS)
    return line


def rows_bwd_split(lines, tag='phase 5'):
    """``gather_rows``' backward per step by part (``check_rows_case``):
    the CSR build, the sums, the hot-row tail, and the CSR build of the
    kernel before (``csr_of``); printed and returned."""
    split = {k: sum(c[k] for c in lines) for k in (
        'ms', 'csr_ms', 'sum_ms', 'sum_warp_rows_ms', 'csr_sort_ms')}
    split['hot_row_tail_ms'] = split['sum_ms'] - split['sum_warp_rows_ms']
    split['long_rows'] = sum(c['long_rows'] for c in lines)
    print(f'[{tag}] gather_rows backward per step, {len(lines)} calls: '
          f'{json.dumps(split)}', flush=True)
    return split


def train_steps(trainer, batch, n_steps, tag='phase 6', model='VirConv-T',
                per_step=None, nmap_convs=None):
    """Phase 6 (and 11c), the main training path: ``n_steps`` steps with
    every launch count set to 0 just before and read just after; no band
    training conv may take its neighbor-map branch. Each step's loss
    terms are printed. ``per_step`` (``per_step_launches`` of the step
    phase 5 captured): each counter must show that many launches per step
    (K1 and K4 as before; ``nmap_conv`` once per neighbor-map conv and once
    per its input gradient, ``nmap_conv_dw`` once per neighbor-map conv and
    once per gather-patch term, ``branch_counts['nmap_train']`` once per
    neighbor-map conv); ``nmap_convs``: the neighbor-map convs a step of
    ``model`` has by its code."""
    import torch
    from virconv_tpu_torch.ops import band_conv, gather_rows, nmap_conv, sparse
    from virconv_tpu_torch.ops import boxes as box_ops
    band_conv.launches = band_conv.dw_launches = 0
    band_conv.patch_launches = box_ops.nms_launches = 0
    gather_rows.launches = gather_rows.bwd_launches = 0
    nmap_conv.launches = nmap_conv.dw_launches = 0
    sparse.branch_counts.clear()
    torch.cuda.reset_peak_memory_stats()
    times, losses, terms = [], [], []
    counter = StepCounts(trainer).__enter__()
    try:
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, tb = trainer.step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(loss))
            terms.append({k: float(v) for k, v in tb.items()})
            print(f'[{tag}] step {len(losses)} loss {losses[-1]!r}, terms '
                  f'{json.dumps(terms[-1])}', flush=True)
            bad = [k for k, v in tb.items() if not np.isfinite(float(v))]
            if not np.isfinite(losses[-1]) or bad:
                fail(f'non-finite training loss {losses[-1]} / terms {bad}')
            if tb['nonfinite_skips'] != 0:
                fail(f'{tb["nonfinite_skips"]} skipped steps')
    finally:
        kinds = counter.take()
        counter.__exit__()
    counts = {'band_conv_fwd': band_conv.launches,
              'band_conv_dw': band_conv.dw_launches,
              'band_conv_patch': band_conv.patch_launches,
              'gather_rows': gather_rows.launches + gather_rows.bwd_launches,
              'gather_rows_bwd': gather_rows.bwd_launches,
              'nmap_conv_fwd': nmap_conv.launches,
              'nmap_conv_dw': nmap_conv.dw_launches,
              'nms': box_ops.nms_launches}
    branches = dict(sparse.branch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'[{tag}] {model} training, {n_steps} steps of '
          f'{batch["points"].shape[0]} entries: ms/step {times}, loss '
          f'{losses}, peak memory {peak_gib:.2f} GiB, launches {counts}, '
          f'conv branches {branches}', flush=True)
    for k in ('band_conv_fwd', 'band_conv_dw', 'gather_rows_bwd',
              'nmap_conv_fwd', 'nmap_conv_dw'):
        if counts[k] == 0:
            fail(f'{k} was never launched on the training path')
    if not branches.get('band_train') or branches.get('band_train_nmap', 0):
        fail(f'a band training conv left the band kernels: {branches}')
    if counts['nms'] != 2 * n_steps:
        fail(f'{counts["nms"]} NMS launches over {n_steps} steps, not 2 a '
             'step')
    if per_step is not None:
        # the gather-patch terms depend on each step's voxels (patched band
        # convs, one nmap_conv_dw each): nmap_conv_dw launches once per
        # neighbor-map conv and once per K1 forward call with a patch
        got = {k: (branches if k == 'nmap_train' else counts).get(k, 0)
               / n_steps for k in per_step}
        dw_want = per_step['nmap_train'] * n_steps + kinds['k1_forward_patch']
        print(f'[{tag}] {model} launches per step {json.dumps(got)} (the '
              f'captured step: {json.dumps(per_step)}; neighbor-map convs '
              f'by the code: {nmap_convs}); nmap_conv_dw '
              f'{counts["nmap_conv_dw"]} over {n_steps} steps: '
              f'{per_step["nmap_train"]} per step and one per K1 forward '
              f'call with a patch ({kinds["k1_forward_patch"]})', flush=True)
        if got != per_step or counts['nmap_conv_dw'] != dw_want:
            fail(f'{model}: launches per step {got}, nmap_conv_dw '
                 f'{counts["nmap_conv_dw"]}; want {per_step}, {dw_want}')
        if nmap_convs is not None and per_step['nmap_train'] != nmap_convs:
            fail(f'{model}: {per_step["nmap_train"]} neighbor-map convs per '
                 f'step, {nmap_convs} by the code')
    return counts, {'ms_per_step': times, 'loss': losses, 'terms': terms,
                    'peak_memory_gib': peak_gib, 'conv_branches': branches,
                    'launches_per_step': per_step,
                    'launches_by_kind': kinds}


def backward_twice(cfg, batch, tag='phase 6b'):
    """The forward and backward of one step, twice, from one fresh trainer
    of ``cfg``: the same inputs, parameters and draws, no optimizer step.
    Every parameter's ``.grad`` is compared bit for bit and the modules
    whose gradients differ are printed; then a third pass under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` lists the
    ops PyTorch knows to be non-repeatable (a listing only: the mode is
    switched off after it). Fails if the two passes differ."""
    import warnings
    import torch
    from virconv_tpu_torch.train.draws import Draws
    from virconv_tpu_torch.train.trainer import Trainer, step_seed
    trainer = Trainer(cfg=cfg, device='cuda', seed=0)
    model, batch = trainer.model, trainer.to_device(batch)

    def one_pass():
        trainer.generator.manual_seed(step_seed(0, 0))
        model.zero_grad(set_to_none=True)
        out = model(batch, rng=Draws(trainer.generator))
        out['loss'].backward()
        torch.cuda.synchronize()
        return float(out['loss']), {n: p.grad.detach().clone()
                                    for n, p in model.named_parameters()
                                    if p.grad is not None}
    (loss_a, a), (loss_b, b) = one_pass(), one_pass()
    differ = {}
    for n, g in a.items():
        if not torch.equal(g, b[n]):
            mod = n.rsplit('.', 1)[0]
            diff = float((g.double() - b[n].double()).abs().max())
            differ[mod] = max(differ.get(mod, 0.0), diff)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            one_pass()
    finally:
        torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split(' does not have')[0][:120]
                      for w in caught
                      if 'deterministic' in str(w.message)})
    print(f'[{tag}] one step\'s backward twice: losses {loss_a!r} / '
          f'{loss_b!r}, {len(a)} gradients, {len(differ)} modules differ: '
          f'{json.dumps(differ)}; ops flagged by the deterministic mode: '
          f'{flagged}', flush=True)
    del trainer, model, a, b
    torch.cuda.empty_cache()
    if differ or loss_a != loss_b:
        fail(f'{tag}: two backward passes of one step differ in '
             f'{sorted(differ)}')
    return {'loss': loss_a, 'modules_differing': differ,
            'ops_flagged_by_deterministic_mode': flagged}


def _parity_step(cfg, batch, device, draws, prepare=None, snap_to=None,
                 values=()):
    """One training step of a fresh trainer of ``cfg`` (seed 1) on
    ``device`` with ``draws``; ``prepare(model)`` edits its weights first.
    The step's forward runs under ``PreActivations(model, snap_to,
    values)``. Returns (the loss, every parameter's gradient on the CPU,
    the records)."""
    from virconv_tpu_torch.train.trainer import Trainer
    tr = Trainer(cfg=cfg, device=device, seed=1)
    if prepare is not None:
        prepare(tr.model)
    rec = PreActivations(tr.model, snap_to, values)
    try:
        loss, _ = tr.step(batch, draws)
    finally:
        rec.remove()
    return float(loss), {n: p.grad.detach().cpu() for n, p in
                         tr.model.named_parameters()}, rec


def train_step_parity(cfg, batch, devices=('cpu', 'cuda'), prepare=None):
    """One training step of ``cfg`` on ``batch`` on each device, from fresh
    trainers with the same weights and the same draws (made once, on the
    first device, and replayed on the second); ``prepare(model)`` edits
    each trainer's weights first. Returns (the loss's
    relative error, (the worst gradient error in units of its scale, its
    parameter), the losses): each parameter's gradient error is taken
    against its max |grad| on the first device, floored at 1e-4 x the
    step's largest gradient (gradients that are zero in exact arithmetic
    are round-off)."""
    import torch
    from virconv_tpu_torch.train.draws import Draws
    draws = Draws(torch.Generator().manual_seed(7))
    l_ref, g_ref, _ = _parity_step(cfg, batch, devices[0], draws, prepare)
    l_dev, g_dev, _ = _parity_step(cfg, batch, devices[1],
                                   Draws(replay=draws.log), prepare)
    loss_rel = abs(l_dev - l_ref) / max(abs(l_ref), 1e-12)
    return loss_rel, _grad_worst(g_dev, g_ref), (l_ref, l_dev)


# the outputs that set a training step's box geometry: the RPN's box,
# class and direction maps (proposals, NMS, top-k) and the cascade's three
# regression heads (each stage's ROIs and the regression loss's boxes)
GEOMETRY_OUTPUTS = ('dense_head.conv_box', 'dense_head.conv_cls',
                    'dense_head.conv_dir', 'roi_head.reg_head',
                    'roi_head.reg_head_pi', 'roi_head.reg_head_p')


def tiny_train_parity(devices=('cpu', 'cuda'), cfg=None, batch=None,
                      tag='phase 7', gate_unsnapped=True):
    """Phase 7 (and 11d): one training step of a tiny config (the tiny
    training config by default) on a synthetic batch, on the first device
    (the reference, its BN outputs and ``GEOMETRY_OUTPUTS`` recorded) and
    three times on the second with the reference's draws: (a) as it is;
    (b) with every BN output that (a) put on the other side of ReLU's kink
    from the reference snapped to the reference's value; (c) as (b) with
    the ``GEOMETRY_OUTPUTS`` replaced by the reference's values, gradients
    passed through (``PreActivations``). Round-off in those outputs moves
    the ROIs and the decoded boxes, and the regression loss's corner and
    box terms (a min of two corner distances, interval overlaps) and the
    pools' ReLUs then pick a branch by round-off: the gradients of (a)
    differ by what a kink passes, though every value agrees. Gates: every
    loss within rtol 1e-4; (c)'s snapped outputs moved by at most 1e-4 x
    their scale and each of its gradients within 1e-3 x its scale; with
    ``gate_unsnapped``, (a)'s gradients within 1e-3 x their scale as well.
    Then the same step with the box-regression outputs zeroed
    (``zero_box_outputs``: the proposals are the anchors, each stage's
    ROIs the previous stage's, on both devices) on each device: the loss
    and every gradient gated as (c). (a)'s and (b)'s worst gradients, by
    scale and by norm, and the kinks crossed are printed. Returns the
    errors."""
    import torch
    from virconv_tpu_torch.configs.tiny import tiny_train_config
    from virconv_tpu_torch.train.draws import Draws
    cfg = tiny_train_config() if cfg is None else cfg
    batch = tiny_train_batch(np.random.default_rng(0)) if batch is None \
        else batch
    draws = Draws(torch.Generator().manual_seed(7))
    l_ref, g_ref, ref = _parity_step(cfg, batch, devices[0], draws,
                                     values=GEOMETRY_OUTPUTS)
    res = {}
    for name, snap_to, values in (
            ('unsnapped', None, ()), ('relu_kinks_snapped', ref.rows, ()),
            ('snapped', ref.rows, GEOMETRY_OUTPUTS)):
        loss, grads, rec = _parity_step(cfg, batch, devices[1],
                                        Draws(replay=draws.log),
                                        snap_to=snap_to, values=values)
        res[name] = {'loss_rel_err': abs(loss - l_ref) / max(abs(l_ref),
                                                             1e-12),
                     'worst_grad': _grad_worst(grads, g_ref),
                     'worst_grad_over_norm': _grad_norm_worst(grads,
                                                              g_ref),
                     'relu_kinks_crossed': sign_flips(ref.rows, rec.rows)}
        if rec.moved:
            res[name]['largest_move_over_scale'] = max(
                (v, k) for k, v in rec.moved.items())
    z_rel, z_worst, (z_ref, z_dev) = train_step_parity(
        cfg, batch, devices, prepare=zero_box_outputs)
    res['zeroed_box_outputs'] = {'loss_rel_err': z_rel,
                                 'worst_grad': z_worst}
    print(f'[{tag}] tiny config training step {devices[1]} vs '
          f'{devices[0]}: loss {l_ref:.6g}; {json.dumps(res)} (tol: loss '
          f'rel 1e-4; snapped and zeroed_box_outputs gradients 1e-3 x '
          f'scale, moves 1e-4 x scale'
          f'{"; unsnapped gradients 1e-3 x scale" if gate_unsnapped else ""})',
          flush=True)
    sn = res['snapped']
    if not (all(r['loss_rel_err'] <= 1e-4 for r in res.values())
            and sn['worst_grad'][0] <= 1e-3
            and sn['largest_move_over_scale'][0] <= 1e-4
            and z_worst[0] <= 1e-3
            and (not gate_unsnapped
                 or res['unsnapped']['worst_grad'][0] <= 1e-3)):
        fail('tiny config training step: devices disagree')
    return res


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


def eval_scene(tmp, frames, batch_size, logger, make_cfg=None,
               tag='phase 9', root=None):
    """Phase 9a (and 11e), the evaluation path at full width: a ``scene``
    KITTI tree of ``frames`` val frames (written once, under ``tmp``), its
    infos, a checkpoint of ``make_cfg``'s model (VirConv-T by default),
    then ``eval_one_ckpt`` on CUDA with every launch count set to 0 just
    before and read just after. Fails unless K1 and K2+K3 were launched,
    the native box library is loaded, each frame has its KITTI dict
    (finite fields) and ``.txt`` file, and the metric has the R40 keys.
    ``root``: a tree with its infos to evaluate in place of the scene
    tree."""
    from virconv_tpu_torch.config import virconv_t_config
    from virconv_tpu_torch.ops import band_conv, native, roi_pool, sparse
    from virconv_tpu_torch.train.eval_loop import eval_one_ckpt
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    t = time.perf_counter()
    root = root or tmp / 'scene'
    if not (root / 'kitti_infos_val.pkl').exists():
        write_tree(root, 'scene', frames=frames, seed=0)
    write_s = time.perf_counter() - t
    cfg = (make_cfg or virconv_t_config)()
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    name = cfg.MODEL.BACKBONE_3D.NAME
    ckpt = eval_checkpoint(cfg, tmp / f'ckpt_full_{name}', seed=0)
    out = tmp / f'eval_full_{name}_{root.name}'
    band_conv.launches = roi_pool.launches = 0
    sparse.branch_counts.clear()
    res = eval_one_ckpt(cfg, ckpt, logger, out, batch_size=batch_size,
                        device='cuda', save_to_file=True, seed=1024)
    if sparse.branch_counts.get('nmap_slow', 0):
        fail(f'a conv context left the band kernel: '
             f'{dict(sparse.branch_counts)}')
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
    print(f'[{tag}] {name} on a scene tree of {frames} frames, batches of '
          f'{batch_size} x ROT_NUM {cfg.DATA_CONFIG.get("ROT_NUM", 1)}: '
          f'sec_per_example {res.sec_per_example:.4f}, loader '
          f'{stats["loader_sec_per_frame"]:.4f} s/frame, seconds '
          f'{json.dumps(res.seconds)}, launches {launches}, detections '
          f'{n_det}, recalls {json.dumps(stats["recalls"])}', flush=True)
    print(f'[{tag}] AP(R40) with random weights (not gated): '
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
    each training step of ``trainer``, and the K1 forward calls with a
    gather patch (read and reset by ``take``), as
    ``TrainCapture`` tells K1's forward calls (while the model's forward
    runs) from its input-gradient calls; the wrapped functions still
    launch the kernels and bump the modules' own counts."""

    KEYS = ('k1_forward', 'k1_input_grad', 'k4', 'k2_k3', 'k1_forward_patch')

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
                    patch = a[8] if len(a) > 8 else k.get('patch')
                    if self._in_forward and patch is not None:
                        self.counts['k1_forward_patch'] += 1
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


L_CONVS = 20        # VirConv-L's sparse convs: 19 NRConv convs and conv_out
# the training convs on the neighbor map per step: T's 3 LiDAR downs,
# conv_out, 3 NRConv downs and 8 NRConv 2D convs; L's 3 downs, 8 2D convs
# and conv_out
NMAP_TRAIN_CONVS = {'VirConv-T': 15, 'VirConv-L': 12}
SEMI_FRAMES, SEMI_N_TRAIN, SEMI_N_SEMI = 3, 2, 2   # phase 11f's tree


def steps_twice(cfg, batch, n_steps, tag, model):
    """Fault C4's gate: two fresh trainers of ``cfg`` (VirConv-T when
    None) from one seed each take ``n_steps`` steps on ``batch``; after
    every step each loss term and every parameter and BN statistic must be
    the same bits in both. Returns each run's losses and ms per step."""
    import torch
    from virconv_tpu_torch.train.trainer import Trainer
    runs = []
    for _ in range(2):
        trainer, steps = Trainer(cfg=cfg, device='cuda', seed=0), []
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, tb = trainer.step(batch)
            torch.cuda.synchronize()
            steps.append((1e3 * (time.perf_counter() - t),
                          {'loss': float(loss),
                           **{k: float(v) for k, v in tb.items()}},
                          {n: v.detach().clone() for n, v in
                           trainer.model.state_dict().items()}))
        runs.append(steps)
        del trainer
        torch.cuda.empty_cache()
    report = {'losses': [[r[1]['loss'] for r in run] for run in runs],
              'ms_per_step': [[r[0] for r in run] for run in runs],
              'differing': []}
    for i, (a, b) in enumerate(zip(*runs)):
        terms = sorted(k for k in a[1] if a[1][k] != b[1][k])
        params = sorted(n for n in a[2] if not torch.equal(a[2][n], b[2][n]))
        report['differing'].append({'terms': terms, 'tensors': params})
        print(f'[{tag}] {model}, two trainers from one seed, step {i + 1}: '
              f'losses {a[1]["loss"]!r} / {b[1]["loss"]!r}; differing loss '
              f'terms {terms}, differing parameters and statistics '
              f'{len(params)} of {len(a[2])} {params[:6]}', flush=True)
    del runs
    torch.cuda.empty_cache()
    if any(d['terms'] or d['tensors'] for d in report['differing']):
        fail(f'{model}: two seeded trainers differ (fault C4)')
    return report


def semi_train_cli(tmp, t_ckpt, batch_size):
    """Phase 11f: ``tools/train_gpu.py --cfg virconv_s`` in this process for
    one epoch (2 steps of ``batch_size`` frames) on a ``scene`` tree with
    SEMI_N_TRAIN train and SEMI_N_SEMI semi frames, from the VirConv-T
    checkpoint ``t_ckpt`` as ``--pretrained_model``. Fails unless the
    batches read frames from both ``training/`` and ``semi/``, every loss
    is finite with no skipped step, and K1 (forward and input gradient)
    and K4 ran on every step."""
    import torch
    from virconv_tpu_torch.datasets.kitti.kitti_dataset_semi import \
        KittiDatasetSemi
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))
    import train_gpu
    t = time.perf_counter()
    root = write_tree(tmp / 'semi_scene', 'scene', frames=SEMI_FRAMES,
                      seed=0, n_train=SEMI_N_TRAIN, n_semi=SEMI_N_SEMI)
    write_s = time.perf_counter() - t
    roots, state = [], {'counter': None, 'steps': []}
    frame_root = KittiDatasetSemi.frame_root

    def recording(self, info):
        root_dir = frame_root(self, info)
        roots.append(root_dir.name)
        return root_dir

    def on_start(trainer, start_epoch, resumed_from):
        state['counter'] = StepCounts(trainer).__enter__()

    def on_step(rec, tb):
        torch.cuda.synchronize()
        state['steps'].append({
            **rec, **state['counter'].take(),
            'terms_finite': all(np.isfinite(float(v)) for v in tb.values())})
    KittiDatasetSemi.frame_root = recording
    try:
        run = train_gpu.main(
            ['--cfg', 'virconv_s', '--batch_size', str(batch_size),
             '--epochs', '1', '--no_eval', '--fix_random_seed',
             '--log_interval', '1', '--output_dir', str(tmp / 'semi_run'),
             '--pretrained_model', str(t_ckpt),
             '--set', 'DATA_CONFIG.DATA_PATH', str(root)],
            on_start, on_step)
    finally:
        KittiDatasetSemi.frame_root = frame_root
        if state['counter'] is not None:
            state['counter'].__exit__()
    steps = state['steps']
    stats = {'frames': SEMI_FRAMES, 'train_frames': SEMI_N_TRAIN,
             'semi_frames': SEMI_N_SEMI, 'tree_write_s': write_s,
             'steps': len(steps),
             'ms_per_step': [1e3 * r['seconds'] for r in steps],
             'loss': [r['loss'] for r in steps],
             'frames_read': {d: roots.count(d) for d in set(roots)},
             'launches_per_step': [{k: r[k] for k in StepCounts.KEYS}
                                   for r in steps],
             'pretrained_model': Path(t_ckpt).name}
    print(f'[phase 11] train_gpu --cfg virconv_s from {Path(t_ckpt).name} '
          f'on a scene tree of {SEMI_N_TRAIN} train + {SEMI_N_SEMI} semi '
          f'frames, batches of {batch_size}: {len(steps)} steps, ms/step '
          f'{[round(x, 1) for x in stats["ms_per_step"]]}, loss '
          f'{stats["loss"]}, frames read by subdirectory '
          f'{stats["frames_read"]}, launches per step '
          f'{stats["launches_per_step"]}', flush=True)
    n_steps = (SEMI_N_TRAIN + SEMI_N_SEMI) // batch_size
    if len(steps) != n_steps or run.frames != n_steps * batch_size:
        fail(f'{len(steps)} VirConv-S steps, expected {n_steps}')
    if not {'training', 'semi'} <= set(roots):
        fail(f'the VirConv-S batches read {sorted(set(roots))}')
    for r in steps:
        if not (np.isfinite(r['loss']) and r['terms_finite']
                and r['nonfinite_skips'] == 0):
            fail(f'VirConv-S step {r["step"]}: loss {r["loss"]}')
        if not (r['k1_forward'] and r['k1_input_grad'] and r['k4']):
            fail(f'VirConv-S step {r["step"]} missed a kernel: {r}')
    return stats


def virconv_l_phase(tmp, logger):
    """Phase 11, VirConv-L at full width (seeded weights): (a) every K1 and
    K2+K3 call of one request and every K1 forward, K1 input-gradient and
    K4 call of one training step against their plain versions; (b)
    N_REQUESTS requests through ``serve.Detector(virconv_l_config())``;
    (c) N_TRAIN_STEPS training steps of ``train_batch_l``, then the first
    seeded step of two fresh trainers; (d) the tiny-L config CUDA vs CPU,
    evaluation and one training step; (e) ``eval_one_ckpt`` on phase 9's
    scene tree. Returns (per-call lines by kernel, the phase's numbers)."""
    import torch
    from virconv_tpu_torch.config import virconv_l_config
    from virconv_tpu_torch.configs.tiny import (tiny_l_config,
                                                tiny_l_train_config)
    from virconv_tpu_torch.serve import Detector
    from virconv_tpu_torch.train.trainer import Trainer
    from virconv_tpu_torch.utils.bench_inputs import (FRAMES, synth_frames_l,
                                                      train_batch_l)
    tag = 'phase 11'
    cfg = virconv_l_config()
    det = Detector(cfg=cfg, device='cuda', seed=0)
    frames = synth_frames_l(FRAMES)
    cases, taps, pools = request_kernel_calls(det, frames, tag)
    n_k1 = len(cases['band_conv_fwd'])
    print(f'[{tag}] one VirConv-L request: {n_k1} of its {L_CONVS} sparse '
          f'convs on K1 (taps {sorted(taps)}), '
          f'{len(cases["band_conv_patch"])} with a gather patch, '
          f'{len(cases["roi_pool_fwd"])} K2+K3 calls (stride, Q) '
          f'{sorted(pools)}', flush=True)
    if n_k1 != L_CONVS or {27, 9, 3} - taps:
        fail(f'{n_k1} K1 calls with taps {sorted(taps)} in one VirConv-L '
             f'request, expected {L_CONVS} with taps 27, 9 and 3')
    if not cases['roi_pool_fwd']:
        fail('no VirConv-L pool took the kernel')
    past_cap = sized_patch_contexts(det, frames, tag)
    per_request = {k: len(cases[k]) for k in ('band_conv_fwd',
                                              'band_conv_patch')}
    counts, serve = serve_requests(det, frames, N_REQUESTS, 'VirConv-L',
                                   per_request, tag)
    serve['contexts_past_the_jax_patch_cap'] = past_cap
    del det
    torch.cuda.empty_cache()
    serve['launches_per_request'] = {k: v / N_REQUESTS
                                     for k, v in counts.items()}
    serve['pool_routes_per_request'] = {
        route: serve['pool_branches'].get(route, 0) / N_REQUESTS
        for route in ('kernel', 'probe')}
    serve['conv_routes_per_request'] = {
        route: n / N_REQUESTS for route, n in serve['conv_branches'].items()}
    with torch.enable_grad():
        trainer = Trainer(cfg=cfg, device='cuda', seed=0)
        batch = trainer.to_device(train_batch_l())
        train_cases = train_kernel_calls(trainer, batch, tag)
        cases.update(train_cases)
        train_counts, train = train_steps(
            trainer, batch, N_TRAIN_STEPS, tag, 'VirConv-L',
            per_step=per_step_launches(train_cases),
            nmap_convs=NMAP_TRAIN_CONVS['VirConv-L'])
        kinds = train['launches_by_kind']
        if not (kinds['k1_forward'] and kinds['k1_input_grad']
                and kinds['k4']):
            fail(f'a VirConv-L training step missed a kernel: {kinds}')
        del trainer
        torch.cuda.empty_cache()
        train['steps_twice'] = steps_twice(cfg, batch, N_TRAIN_STEPS, tag,
                                           'VirConv-L')
        del batch
        torch.cuda.empty_cache()
        tiny_batch = {k: v for k, v in
                      tiny_train_batch(np.random.default_rng(0)).items()
                      if not k.startswith('points_mm')}
        tiny_train = tiny_train_parity(('cpu', 'cuda'), tiny_l_train_config(),
                                       tiny_batch, tag)
    tiny_eval = tiny_serve_parity(tiny_l_config(), tag=tag)
    evaluation = eval_scene(tmp, EVAL_FRAMES, FRAMES, logger,
                            virconv_l_config, tag)
    return cases, {'serve': {'launches': counts, **serve},
                   'train': {'launches': train_counts, **train},
                   'tiny_cuda_vs_cpu': {'eval': tiny_eval,
                                        'train': tiny_train},
                   'eval': evaluation}


VP_FRAMES = 4          # phase 12's scene tree
CSPN_PER_FRAME = 12    # 6 iterations x 2 stages


class CspnCapture:
    """Records the inputs of every CSPN kernel call while it is entered
    (the calls still launch)."""

    def __init__(self):
        from virconv_tpu_torch.ops import cspn
        self.calls, self._cspn, self._orig = [], cspn, cspn._cspn_cuda

    def __enter__(self):
        def rec(*args):
            self.calls.append(args)
            return self._orig(*args)
        self._cspn._cspn_cuda = rec
        return self

    def __exit__(self, *exc):
        self._cspn._cspn_cuda = self._orig
        return False


def check_cspn_case(name, args):
    """One CSPN iteration of the full-width frame: the kernel against the
    plain version on the same CUDA tensors, bit for bit (int32 views), both
    timed (the kernel's device time apart, ``device_ms``), and the bound:
    the guides, depths and maps read once and the three depths written
    once; 2 operations per tap and 4 for the blend per pixel and kernel
    size, at the f32 peak."""
    from virconv_tpu_torch.ops import cspn
    guides, ds, h0, mask, dsparse, dilation, half_res = args
    b, _, h, w = h0.shape
    line = {'case': name, 'rows': b * h * w, 'stage': 's2' if half_res
            else 's1', 'dilation': dilation}
    got = cspn.cspn_iteration(guides, ds, h0, mask, dsparse, dilation,
                              half_res)
    want = cspn.cspn_iteration_plain(guides, ds, h0, mask, dsparse,
                                     dilation, half_res)
    line['max_abs_err_f32'] = max(float((g - x).abs().max())
                                  for g, x in zip(got, want))
    line['bit_equal'] = all(bits_equal(g, x) for g, x in zip(got, want))
    if not line['bit_equal']:
        fail(f'cspn {name}: the kernel differs from the plain version in '
             f'its bits (max err {line["max_abs_err_f32"]})')
    line['ms'] = cuda_ms(lambda: cspn.cspn_iteration(
        guides, ds, h0, mask, dsparse, dilation, half_res))
    line['device_ms'] = graph_ms(lambda: cspn.cspn_iteration(
        guides, ds, h0, mask, dsparse, dilation, half_res))
    line['plain_ms'] = cuda_ms(lambda: cspn.cspn_iteration_plain(
        guides, ds, h0, mask, dsparse, dilation, half_res), reps=3, warmup=1)
    # each input once: the first iteration passes one tensor as all depths
    ins = {t.data_ptr(): t for t in (*guides, *ds, h0, mask, dsparse)}
    line['bytes'] = nbytes(*ins.values()) + 3 * nbytes(h0)
    line['ops'] = float(b * h * w) * sum(2 * k * k + 4
                                          for k in cspn.KERNEL_SIZES)
    bound(line, F32_FLOPS)
    return line


def check_velodyne_depth(split, fid, n_points, n_lidar):
    """One generated file: float16, 8 columns, the scan first (indicator
    2, intensity x 10), then the virtual points (indicator 1, z < 1).
    Returns the share of virtual points with a colour."""
    pts = np.load(split / 'velodyne_depth' / f'{fid}.npy')
    lidar = np.fromfile(split / 'velodyne' / f'{fid}.bin',
                        np.float32).reshape(-1, 4)
    ind = pts[:, 7].astype(np.float32) if pts.ndim == 2 else None
    ok = (pts.dtype == np.float16 and pts.ndim == 2 and pts.shape[1] == 8
          and len(pts) == n_points and len(lidar) == n_lidar
          and n_points > n_lidar and (ind[:n_lidar] == 2).all()
          and (ind[n_lidar:] == 1).all()
          and np.array_equal(pts[:n_lidar, 3],
                             (lidar[:, 3] * 10).astype(np.float16))
          and (pts[n_lidar:, 2].astype(np.float32) <= 1.0).all()
          and np.isfinite(pts.astype(np.float32)).all())
    if not ok:
        fail(f'velodyne_depth/{fid}.npy: {pts.dtype} {pts.shape}, '
             f'{n_lidar} LiDAR rows, not the fused format')
    return float((pts[n_lidar:, 4:7] > 0).any(1).mean())


D2P_FRAMES = 4         # phase 12f's street depths
D2P_REPS = 20          # timed calls of each


def depth2points_cases(prep, tag):
    """Phase 12f: the depth2points tail (``ops.depth2points.virtual_cloud``,
    ``csrc/depth2points.cu``) on D2P_FRAMES street depths
    (``mini_kitti.street_depth``) with ``prep``'s crop, calibration and
    scan: the fused cloud against numpy's ``frame_points`` bit for bit;
    per frame the host ms of a call (its two syncs and numpy's angles
    included; median of D2P_REPS after a warm call), the kernels' device
    ms (CUDA events around ``project`` and ``thin``), the library calls a
    call (two, or the phase fails), the table's slots, the bound by the
    bytes the tail needs (each once: the depth, 28 B a kept row, 27 B a
    winner) and numpy's ms. First, this host's np.dot must sum in the
    kernels' orders (``host_order_holds``)."""
    import statistics
    import torch
    from virconv_tpu_torch.models.depth_completion import virtual_points as vp
    from virconv_tpu_torch.models.depth_completion.depth2points import \
        lidar_rows
    from virconv_tpu_torch.ops import depth2points as d2p
    from virconv_tpu_torch.utils.mini_kitti import street_depth
    _, rgb_c, _, _, k_mat, calib, lidar, _ = prep
    if not d2p.host_order_holds():
        fail('depth2points: this host\'s np.dot sums in another order than '
             'the kernels')
    cam = d2p.camera_params(vp.crop_calibration(k_mat, calib))
    rgb = torch.from_numpy(np.ascontiguousarray(rgb_c)).cuda()
    wrapped = {name: getattr(d2p, name) for name in ('project', 'thin')}
    cases = []
    for seed in range(D2P_FRAMES):
        depth_np = street_depth(np.random.default_rng(seed))
        depth = torch.from_numpy(depth_np).cuda()
        t = time.perf_counter()
        want = vp.frame_points(depth_np, rgb_c, k_mat, calib, lidar)
        numpy_ms = 1e3 * (time.perf_counter() - t)
        rows, n_in = d2p.virtual_cloud(depth, rgb, cam)
        got = np.concatenate([lidar_rows(lidar).astype(np.float16), rows])
        if got.shape != want.shape or not np.array_equal(
                got.view(np.uint16), want.view(np.uint16)):
            fail(f'depth2points street {seed}: the kernels\' cloud differs '
                 f'from numpy\'s')
        events = {name: [] for name in wrapped}

        def timed(name):
            def call(*args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = wrapped[name](*args)
                end.record()
                events[name].append((start, end))
                return out
            return call
        host_ms, launches, boxes = [], d2p.launches, []
        table_box = d2p.table_box

        def boxed(*args):
            boxes.append(table_box(*args))
            return boxes[-1]
        try:
            d2p.table_box = boxed
            for name in wrapped:
                setattr(d2p, name, timed(name))
            for _ in range(D2P_REPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                d2p.virtual_cloud(depth, rgb, cam)
                host_ms.append(1e3 * (time.perf_counter() - t))
        finally:
            d2p.table_box = table_box
            for name, fn in wrapped.items():
                setattr(d2p, name, fn)
        torch.cuda.synchronize()
        calls = (d2p.launches - launches) / D2P_REPS
        if calls != 2:
            fail(f'depth2points street {seed}: {calls} library calls a '
                 f'frame, not 2')
        device = {name: statistics.median(s.elapsed_time(e) for s, e in ev)
                  for name, ev in events.items()}
        n = int(d2p.project(depth, cam)[0][0])
        nbytes = 4 * depth_np.size + 28 * n + 27 * len(rows)
        _, v_rows, _, h_cols = boxes[-1]
        case = {'name': f'street {seed}', 'pixels_in_range': n_in,
                'kept_rows': n, 'thinned': len(rows),
                'table_slots': v_rows * h_cols,
                'ms': statistics.median(host_ms),
                'ms_range': [min(host_ms), max(host_ms)],
                'device_ms': sum(device.values()), 'device_ms_by_call': device,
                'calls': calls,
                'bound_ms': 1e3 * nbytes / HBM_BYTES_PER_S,
                'numpy_ms': numpy_ms}
        cases.append(case)
        print(f'[{tag}] depth2points {case["name"]}: numpy\'s bits; '
              f'{n_in} in range, {n} kept, {len(rows)} thinned; ms '
              f'{case["ms"]:.3f} (device {case["device_ms"]:.4f}: '
              f'{json.dumps(device)}), {case["calls"]} calls, '
              f'{v_rows * h_cols} table slots, bound '
              f'{case["bound_ms"]:.4f}, numpy {numpy_ms:.1f}', flush=True)
    return cases


def virtual_points_phase(tmp, logger):
    """Phase 12, PENet virtual points at full width (seeded weights): (a)
    build PENetC2 on the card; (b) every CSPN kernel launch of one
    352 x 1216 frame against the plain version, and the frame's depth
    twice with the same bits; (c)
    ``tools/generate_virtual_points_gpu.py``'s ``main`` over a
    VP_FRAMES-frame scene tree with the CSPN count set to 0 just before
    and read just after (CSPN_PER_FRAME per frame), each file checked,
    every frame's points made on the depth2points kernels; (d)
    ``eval_one_ckpt`` of VirConv-T over the generated tree (K1 and K2+K3
    launched); (f) ``depth2points_cases``; (e) PENetC2 at 64 x 96 on CUDA
    against the CPU, the depth within 1e-4 x scale. Returns (per-call
    lines, the numbers)."""
    import torch
    from virconv_tpu_torch.models.depth_completion import virtual_points as vp
    from virconv_tpu_torch.models.depth_completion.penet import PENetC2
    from virconv_tpu_torch.ops import cspn
    from virconv_tpu_torch.ops import depth2points as d2p
    from virconv_tpu_torch.utils.bench_inputs import FRAMES
    from virconv_tpu_torch.utils.jax_weights import random_init_
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    from virconv_tpu_torch.utils.png import read_png
    sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))
    import generate_virtual_points_gpu as cli
    tag = 'phase 12'
    t = time.perf_counter()
    gen = vp.VirtualPointGenerator(device='cuda')
    build_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in gen.model.parameters())
    root = write_tree(tmp / 'vp_scene', 'scene', frames=VP_FRAMES, seed=0)
    split = root / 'training'
    print(f'[{tag}] PENetC2 on the card: {n_params} parameters, built and '
          f'seeded in {build_s:.2f} s; a scene tree of {VP_FRAMES} frames',
          flush=True)

    prep = vp.prepare_frame(split, '000000')
    with CspnCapture() as cap:
        depth = gen.complete(*prep[1:5])
    torch.cuda.synchronize()
    if len(cap.calls) != CSPN_PER_FRAME or not np.isfinite(depth).all():
        fail(f'one frame made {len(cap.calls)} CSPN launches')
    images = sorted((split / 'image_2').glob('*.png'))
    t = time.perf_counter()
    for path in images:          # the library is built: prepare_frame ran
        read_png(path)
    png_s = (time.perf_counter() - t) / len(images)
    repeat = gen.complete(*prep[1:5])
    print(f'[{tag}] one frame\'s depth twice: the same bits '
          f'{np.array_equal(depth, repeat)}', flush=True)
    if not np.array_equal(depth, repeat):
        fail('two forwards of one frame give different depths')
    cases = [check_cspn_case(f'{i:02d}', a) for i, a in enumerate(cap.calls)]
    for line in cases:
        print(f'[{tag}] cspn {short(line)}', flush=True)
    per_launch(cases, 'stage', tag, 'cspn')
    print(f'[{tag}] cspn per frame: ms {sum(c["ms"] for c in cases):.4f} '
          f'(device {sum(c["device_ms"] for c in cases):.4f}), bound '
          f'{sum(c["bound_ms"] for c in cases):.4f}', flush=True)
    del cap, gen
    torch.cuda.empty_cache()

    cspn.launches = 0
    d2p.counts.clear()
    d2p.launches = 0
    res = cli.main(['--detpath', str(split)])
    launches = cspn.launches
    if (d2p.counts['kernel'] != len(res.frames) or d2p.counts['plain']
            or d2p.launches != 2 * len(res.frames)):
        fail(f'depth2points: {dict(d2p.counts)} and {d2p.launches} library '
             f'calls over {len(res.frames)} frames, not every frame on the '
             f'kernels, two calls each')
    colour = [check_velodyne_depth(split, f, n, m) for f, n, m in
              zip(res.frames, res.points, res.lidar_points)]
    per_frame = res.per_frame()
    stats = {'frames': len(res.frames), 'image_shape': list(prep[0].shape),
             'crop': [vp.CROP_H, vp.CROP_W], 'parameters': n_params,
             'cspn_launches': launches,
             'cspn_launches_per_frame': launches / max(len(res.frames), 1),
             'png_read_s_per_image': png_s,
             'points_per_frame': res.points,
             'lidar_points_per_frame': res.lidar_points,
             'coloured_virtual_share': colour,
             'seconds_per_frame': per_frame, 'seconds': res.seconds}
    print(f'[{tag}] generate_virtual_points_gpu over {len(res.frames)} '
          f'frames ({prep[0].shape[0]} x {prep[0].shape[1]} images): '
          f'seconds per frame {json.dumps(per_frame)} (the PNG read alone '
          f'{png_s:.4f} s per image), CSPN launches per frame '
          f'{stats["cspn_launches_per_frame"]}, points per frame '
          f'{res.points} (LiDAR {res.lidar_points}), coloured virtual '
          f'share {[round(c, 3) for c in colour]}', flush=True)
    if len(res.frames) != VP_FRAMES or launches != CSPN_PER_FRAME * VP_FRAMES:
        fail(f'{launches} CSPN launches over {len(res.frames)} frames')

    stats['eval'] = eval_scene(tmp, VP_FRAMES, FRAMES, logger, tag=tag,
                               root=root)
    stats['depth2points'] = depth2points_cases(prep, tag)

    rng = np.random.default_rng(0)
    h, w = 64, 96
    rgb = rng.uniform(0, 255, (1, 3, h, w)).astype(np.float32)
    d = ((rng.uniform(size=(1, 1, h, w)) < 0.08)
         * rng.uniform(2, 60, (1, 1, h, w))).astype(np.float32)
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    pos = np.stack([2 * us / (w - 1) - 1, 2 * vs / (h - 1) - 1])[None]
    k = np.array([[[721.5, 0, w / 2], [0, 721.5, h / 2], [0, 0, 1]]],
                 np.float32)
    model = random_init_(PENetC2(), 0).eval()
    outs = {}
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, deterministic=True, allow_tf32=False):
        for dev in ('cpu', 'cuda'):
            model = model.to(dev)
            outs[dev] = model(*[torch.from_numpy(np.float32(x)).to(dev)
                                for x in (rgb, d, pos, k)]).cpu()
    scale = float(outs['cpu'].abs().max())
    err = float((outs['cuda'] - outs['cpu']).abs().max())
    stats['small_cuda_vs_cpu'] = {'max_abs_err': err, 'scale': scale}
    print(f'[{tag}] PENetC2 at {h} x {w}, CUDA vs CPU: depth max err '
          f'{err:.3g}, scale {scale:.4g} (tol 1e-4 x scale)', flush=True)
    if not (np.isfinite(scale) and err <= 1e-4 * max(scale, 1.0)):
        fail('PENetC2 at 64 x 96: CUDA and CPU disagree')
    del model
    torch.cuda.empty_cache()
    return cases, stats


# ---- phase 13: the JAX package's precision switches ------------------------

class Switches:
    """Sets the JAX package's ``VIRCONV_*`` environment switches for the
    ``with`` block and restores them after; the port reads them as its
    conv contexts and pools are built, so one process can flip them."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


BF16_ULP = 2.0 ** -7        # one bf16 ulp, relative, at most


def check_bf16_feats_case(name, args):
    """One K1 call of a request under ``VIRCONV_BF16_FEATS`` (bf16 operands
    and bf16 output rows; bf16 input rows past each stream's first layer):
    the kernel's rows within one bf16 ulp of the plain version's f32 rows
    on the same inputs (2^-7 |ref| + 1e-4 x the output scale), the share
    bit-equal to the plain version's bf16 rows; kernel and plain times of
    the call without its gather patch (as phase 2), and the bound at bf16
    rows (each input read once, the bf16 output written once)."""
    import torch
    from virconv_tpu_torch.ops import band_conv as bc
    feats, keys, plan, w, scale, bias, relu, patch = args
    out = torch.bfloat16
    line = {'case': name, 'rows_in': feats.shape[0], 'rows_out': plan.n_out,
            'c_in': w.shape[1], 'c_out': w.shape[2], 'taps': w.shape[0],
            'feats_dtype': str(feats.dtype).replace('torch.', ''),
            'patch_rows': 0 if patch is None else patch[0].shape[0]}
    got = bc.band_conv(feats, keys, plan, w, scale, bias, relu, True, patch,
                       out)
    want = bc.band_conv_plain(feats, keys, plan, w, scale, bias, relu, True,
                              patch)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    excess = float(((got.float() - want).abs() - BF16_ULP * want.abs())
                   .max())
    if got.dtype != out or not excess <= tol:
        fail(f'band_conv bf16 features {name}: {got.dtype}, beyond one bf16 '
             f'ulp by {excess} > {tol}')
    line['max_abs_err_bf16'] = float((got.float()
                                      - want.to(out).float()).abs().max())
    line['bit_equal_share'] = float((got == want.to(out)).float().mean())
    line['ms'] = cuda_ms(lambda: bc.band_conv(feats, keys, plan, w, scale,
                                              bias, relu, True, None, out))
    line['plain_ms'] = cuda_ms(lambda: bc.band_conv_plain(
        feats, keys, plan, w, scale, bias, relu, True, None, out), reps=3,
        warmup=1)
    hits = taps_hit(feats, keys, plan, plan.valid_bits)
    line['taps_hit'] = hits
    line['bytes'] = (nbytes(feats, keys, plan.base_keys, plan.valid_bits,
                            plan.blk, w) + plan.n_out * w.shape[2] * 2)
    line['ops'] = 2.0 * hits * w.shape[1] * w.shape[2]
    bound(line, BF16_FLOPS)
    return line


def matched_roi_diffs(raw, ref, tol=0.1):
    """The ROI head's outputs of two forwards of one batch (``raw`` against
    ``ref``), compared ROI by ROI: each valid ROI of ``ref`` is matched to
    the nearest unused valid ROI of ``raw`` in the same frame whose seven
    box numbers all lie within ``tol`` (the proposals' order after NMS
    may differ, so a diff by position compares other boxes). Returns the
    matched and total counts, the largest ROI difference over matched
    pairs, and the largest box (heading wrapped to [-pi, pi)) and logit
    differences of their predictions; the unmatched ROIs' predictions
    are compared nowhere."""
    import torch
    rois, rois_ref = (x['rois'][..., :7].float() for x in (raw, ref))
    ok, ok_ref = raw['roi_valid'], ref['roi_valid']
    n_match = n_ref = 0
    roi_d = box_d = cls_d = 0.0
    for b in range(rois.shape[0]):
        cand = ok[b].nonzero()[:, 0]
        want = ok_ref[b].nonzero()[:, 0]
        n_ref += len(want)
        if not len(cand) or not len(want):
            continue
        d = (rois_ref[b, want][:, None] - rois[b, cand][None]).abs()
        d[..., 6] = torch.remainder(d[..., 6] + math.pi, 2 * math.pi) - math.pi
        d = d.abs().amax(-1)                               # (want, cand)
        used = set()
        for i in d.amin(1).argsort().tolist():
            for j in d[i].argsort().tolist():
                if d[i, j] > tol:
                    break
                if j not in used:
                    used.add(j)
                    r, q = int(want[i]), int(cand[j])
                    n_match += 1
                    roi_d = max(roi_d, float(d[i, j]))
                    bd = (raw['batch_box_preds'][b, q].float()
                          - ref['batch_box_preds'][b, r].float())
                    bd[6] = torch.remainder(bd[6] + math.pi, 2 * math.pi) \
                        - math.pi
                    box_d = max(box_d, float(bd.abs().max()))
                    cls_d = max(cls_d, float(
                        (raw['batch_cls_preds'][b, q].float()
                         - ref['batch_cls_preds'][b, r].float()).abs().max()))
                    break
    return {'rois_matched': n_match, 'rois_ref': n_ref,
            'matched_roi_max_abs_diff': roi_d,
            'matched_box_preds_max_abs_diff': box_d,
            'matched_cls_preds_max_abs_diff': cls_d}


def bf16_feats_requests(det, frames, model, tag='phase 13a'):
    """Phase 13a for one detector: under ``VIRCONV_BF16_FEATS=1`` every K1
    call of one request (captured from a warm-up forward; all bf16 out,
    bf16 operands) against its plain version (``check_bf16_feats_case``),
    then N_REQUESTS requests gated as phase 3 (the warm-up's K1 and patch
    launches per request, no context on the neighbor-map branch); the raw
    outputs and detections against the same detector's f32-feature
    request, ROI by ROI (``matched_roi_diffs``), reported and not gated.
    Returns (per-call lines, launch
    counts, the run's numbers)."""
    import torch
    with Switches(VIRCONV_BF16_FEATS='1'):
        with Capture() as cap:
            det.forward(frames)
            torch.cuda.synchronize()
        if set(cap.band_modes) != {(True, torch.bfloat16)}:
            fail(f'{model} K1 under VIRCONV_BF16_FEATS: (operands bf16, '
                 f'output dtype) {sorted(set(map(str, cap.band_modes)))}')
        n_bf16_in = sum(a[0].dtype == torch.bfloat16 for a in cap.band)
        if not n_bf16_in:
            fail(f'no {model} K1 call read bf16 rows')
        lines = []
        for i, a in enumerate(cap.band):
            lines.append(check_bf16_feats_case(
                f'{i:02d} {band_kind(a[0], a[2], a[3])}', a))
            print(f'[{tag}] {model} band_conv bf16 features '
                  f'{short(lines[-1])}', flush=True)
        per_request = {'band_conv_fwd': len(cap.band),
                       'band_conv_patch': sum(a[7] is not None
                                              for a in cap.band)}
        del cap
        counts, run = serve_requests(det, frames, N_REQUESTS,
                                     f'{model} (bf16 features)', per_request,
                                     tag)
        raw = det.forward(frames)
        dets = [len(r['scores']) for r in det(frames)]
    raw32 = det.forward(frames)
    dets32 = [len(r['scores']) for r in det(frames)]
    run['k1_calls_reading_bf16_rows'] = n_bf16_in
    run['vs_f32_features'] = {
        'detections_per_frame': dets, 'detections_per_frame_f32': dets32,
        **matched_roi_diffs(raw, raw32)}
    print(f'[{tag}] {model}: {len(lines)} K1 calls, {n_bf16_in} reading '
          f'bf16 rows; per request {json.dumps(summed(lines))}; against '
          f'f32 features (not gated) {json.dumps(run["vs_f32_features"])}',
          flush=True)
    return lines, counts, run


def band_train_bf16_step(batch, tag='phase 13b'):
    """Phase 13b: under ``VIRCONV_BAND_TRAIN_BF16=1`` every K1 forward, K1
    input-gradient and K4 call of one full-width VirConv-T training step
    (all with bf16 operands) against its plain version, as phase 5,
    timed with bf16 operands and bounded at the bf16 peak; then 2 steps
    gated as phase 6. Returns (per-call lines by kernel, launch counts,
    the run's numbers)."""
    import torch
    from virconv_tpu_torch.train.trainer import Trainer
    with Switches(VIRCONV_BAND_TRAIN_BF16='1'), torch.enable_grad():
        trainer = Trainer(device='cuda', seed=0)
        cap = TrainCapture(trainer.model)
        with cap:
            trainer.step(batch)
        torch.cuda.synchronize()
        if not (cap.fwd and cap.dgrad and cap.dw) or not all(cap.bf16):
            fail(f'a K1 or K4 call of the bf16 training step took f32 '
                 f'operands: {cap.bf16}')
        cases = {'band_conv_fwd_train': [], 'band_conv_fwd_train_dgrad': [],
                 'band_conv_dw': []}
        with torch.no_grad():
            for key, calls in (('band_conv_fwd_train', cap.fwd),
                               ('band_conv_fwd_train_dgrad', cap.dgrad)):
                for i, a in enumerate(calls):
                    line = check_band_case(
                        f'{i:02d} {band_kind(a[0], a[2], a[3])}', a,
                        bf16_timed=True, peak=BF16_FLOPS)
                    line.pop('patch', None)
                    cases[key].append(line)
                    print(f'[{tag}] {key} {short(line)}', flush=True)
            for i, a in enumerate(cap.dw):
                line = check_dw_case(f'{i:02d} k{len(a[2].deltas)}', a,
                                     bf16_timed=True, peak=BF16_FLOPS)
                cases['band_conv_dw'].append(line)
                print(f'[{tag}] band_conv_dw {short(line)}', flush=True)
        del cap
        counts, run = train_steps(trainer, batch, 2, tag,
                                  'VirConv-T (bf16 band convs)')
        del trainer
    torch.cuda.empty_cache()
    return cases, counts, run


def pool_f32_request(det, frames, tag='phase 13c'):
    """Phase 13c: under ``VIRCONV_POOL_BF16=0`` one VirConv-T request with
    bf16 convs: every K2+K3 call takes f32 feature operands and is held
    against its plain version as phase 2 (identical selections, 1e-4 x
    scale), timed at f32. Returns the per-call lines."""
    import torch
    from virconv_tpu_torch.ops import roi_pool
    with Switches(VIRCONV_POOL_BF16='0'):
        roi_pool.launches = 0
        with Capture() as cap:
            det.forward(frames)
            torch.cuda.synchronize()
        launched = roi_pool.launches
    if not cap.pool or any(cap.pool_bf16) or launched != len(cap.pool):
        fail(f'VIRCONV_POOL_BF16=0: pool operands bf16 {cap.pool_bf16}, '
             f'{launched} launches')
    if not all(bf16 for bf16, _ in cap.band_modes):
        fail('VIRCONV_POOL_BF16=0 changed the convs\' operands')
    lines = []
    for i, a in enumerate(cap.pool):
        lines.append(check_pool_case(f'{i} stride{a[6]}_q{a[0].q_per_roi}',
                                     a, bf16_timed=False))
        print(f'[{tag}] roi_pool f32 operands {short(lines[-1])}',
              flush=True)
    return lines, launched


def od_loss_step(batch, tag='phase 13d'):
    """Phase 13d: one full-width VirConv-T training step with the RPN's
    ODIoU term (``DENSE_HEAD.OD_LOSS: True``): a finite, positive
    ``rpn_loss_od``, finite loss terms, no skipped step."""
    import torch
    from virconv_tpu_torch.config import virconv_t_config
    from virconv_tpu_torch.train.trainer import Trainer
    cfg = virconv_t_config()
    cfg.MODEL.DENSE_HEAD.OD_LOSS = True
    with torch.enable_grad():
        trainer = Trainer(cfg=cfg, device='cuda', seed=0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, tb = trainer.step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
    terms = {k: float(v) for k, v in tb.items()}
    print(f'[{tag}] VirConv-T training step with OD_LOSS: {ms:.1f} ms, loss '
          f'{float(loss)!r}, terms {json.dumps(terms)}', flush=True)
    if 'rpn_loss_od' not in terms or not terms['rpn_loss_od'] > 0:
        fail(f'no positive rpn_loss_od in {terms}')
    if not np.isfinite(float(loss)) or not all(
            np.isfinite(v) for v in terms.values()):
        fail('non-finite loss with OD_LOSS')
    if terms['nonfinite_skips'] != 0:
        fail('the OD_LOSS step was skipped')
    del trainer
    torch.cuda.empty_cache()
    return {'ms': ms, 'loss': float(loss), 'terms': terms}


def precision_phase(frames):
    """Phase 13: the JAX package's precision switches at full width, each
    set just around its part: (a) ``VIRCONV_BF16_FEATS=1`` for VirConv-T
    and VirConv-L requests; (b) ``VIRCONV_BAND_TRAIN_BF16=1`` for a
    VirConv-T training step; (c) ``VIRCONV_POOL_BF16=0`` for a VirConv-T
    request with bf16 convs; (d) a VirConv-T step with ``OD_LOSS``.
    Returns (per-call lines by part, launch counts by part, the numbers)."""
    import torch
    from virconv_tpu_torch.config import virconv_l_config
    from virconv_tpu_torch.serve import Detector
    from virconv_tpu_torch.utils.bench_inputs import (FRAMES, synth_frames_l,
                                                      train_batch)
    det = Detector(device='cuda', seed=0)
    t_lines, t_counts, t_run = bf16_feats_requests(det, frames, 'VirConv-T')
    pool_lines, pool_launches = pool_f32_request(det, frames)
    del det
    det_l = Detector(cfg=virconv_l_config(), device='cuda', seed=0)
    l_lines, l_counts, l_run = bf16_feats_requests(
        det_l, synth_frames_l(FRAMES), 'VirConv-L')
    del det_l
    torch.cuda.empty_cache()
    batch = train_batch()
    train_cases, train_counts, train_run = band_train_bf16_step(batch)
    od = od_loss_step(batch)
    cases = {'bf16_feats': t_lines, 'bf16_feats_virconv_l': l_lines,
             'pool_f32': pool_lines, **{f'{k}_bf16': v
                                        for k, v in train_cases.items()}}
    counts = {'bf16_feats': t_counts, 'bf16_feats_virconv_l': l_counts,
              'pool_f32': pool_launches, 'train_bf16': train_counts}
    return cases, counts, {'bf16_feats': t_run,
                           'bf16_feats_virconv_l': l_run,
                           'train_bf16': train_run, 'od_loss': od}


DP_WORLD = 2          # phase 14: ranks, all on cuda:0 over gloo
# the timing run's steps per rank: a first, a warm one, a warm one with
# its collectives timed (each synchronized)
DP_TIMING = (False, False, True)
# phase 14a's equality batch: the x, y box (m) of each entry's LiDAR and
# virtual points (on the H100: the largest boxes tried whose caps hold
# in one process and on each rank)
DP_CROP = {'points': (0, 15, -8, 8), 'points_mm': (0, 10, -5, 5)}


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def dp_cli_rank(rank, world, payload):
    """Rank ``rank`` of a ``--launcher pytorch`` run of ``tools/<tool>.py``
    (phase 14c, 14d): torchrun's environment, then the CLI's ``main`` in
    this process with every launch count set to 0 just before and read
    just after. Returns what the checks need."""
    from virconv_tpu_torch.ops import band_conv, gather_rows, roi_pool
    tool, argv, port, cfg = payload
    sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(port))
    band_conv.launches = band_conv.dw_launches = roi_pool.launches = 0
    gather_rows.launches = gather_rows.bwd_launches = 0
    if tool == 'test_gpu':
        import test_gpu
        if cfg is not None:          # a CPU rehearsal's tiny config
            test_gpu.CONFIGS['virconv_t'] = lambda: cfg
        res = test_gpu.main(argv)[0]
        out = None if res is None else {
            'det_annos': res.det_annos, 'result': res.result_dict,
            'frames': res.frames, 'sec_per_example': res.sec_per_example}
    else:
        import train_gpu
        if cfg is not None:
            train_gpu.CONFIGS['virconv_t'] = lambda: cfg
        run = train_gpu.main(argv)
        out = {'steps': run.steps, 'frames': run.frames,
               'checkpoints': [p.name for p in run.checkpoints],
               'eval': None if run.eval is None else {
                   'result': run.eval.result_dict,
                   'frames': run.eval.frames}}
    return {'result': out, 'launches': {
        'band_conv_fwd': band_conv.launches,
        'band_conv_dw': band_conv.dw_launches,
        'roi_pool_fwd': roi_pool.launches,
        'gather_rows': gather_rows.launches + gather_rows.bwd_launches}}


def _grad_worst(got, want):
    """(the worst gradient error in units of its scale, its parameter):
    phase 7's rule, each scale floored at 1e-4 x the step's largest."""
    floor = 1e-4 * max(float(g.abs().max()) for g in want.values())
    return max((float((got[n] - g).abs().max())
                / max(float(g.abs().max()), floor), n)
               for n, g in want.items())


def _worst_over(got, want, atol, rtol):
    """(the worst |got - want| / (atol + rtol |want|), its name)."""
    return max((float(((got[n].double() - w.double()).abs()
                       / (atol + rtol * w.double().abs())).max()), n)
               for n, w in want.items())


def _bits(a, b):
    """Dicts of tensors with the same bits (float32 by int32 view)."""
    import torch
    return set(a) == set(b) and all(
        bits_equal(a[n], b[n]) if b[n].dtype == torch.float32
        else torch.equal(a[n], b[n]) for n in b)


def dp_batch():
    """Phase 6's batch (``train_batch()``: 2 frames x ROT_NUM 3 at full
    width) with each entry's points outside the BEV boxes of ``DP_CROP``
    (x0, x1, y0, y1 metres, per stream) made invalid: the boxes keep every
    capacity cap from binding, in one process and on each rank. On the
    whole batch one process's caps drop rows, and each rank's caps, sized
    from its own entries, drop others."""
    from virconv_tpu_torch.utils.bench_inputs import train_batch
    batch = train_batch()
    for pts, (x0, x1, y0, y1) in DP_CROP.items():
        x, y = batch[pts][..., 0], batch[pts][..., 1]
        batch[f'{pts}_valid'] = batch[f'{pts}_valid'] & (x >= x0) \
            & (x < x1) & (y >= y0) & (y < y1)
    return batch


def zero_box_outputs(model):
    """Zero the box-regression outputs of the RPN (``conv_box``) and of the
    cascade's three regression heads: the proposals are then the anchor
    boxes exactly and each stage's ROIs the previous stage's, on any
    device and in any reduction order. With random regression weights the
    proposals of two runs that sum in other orders differ by round-off,
    and one proposal whose IoU sits on a sampling threshold changes the
    sampled ROIs and, through the cascade's batch-wide BN, every stage
    after it (on the H100: losses 2.1e-3 apart). Every other layer
    keeps its seeded weights."""
    import torch
    with torch.no_grad():
        for conv in (model.dense_head.conv_box, model.roi_head.reg_head.out,
                     model.roi_head.reg_head_pi.out,
                     model.roi_head.reg_head_p.out):
            conv.weight.zero_()
            conv.bias.zero_()
    return model


class NmsRecord:
    """Records the RPN's NMS selections of a step (``box_ops.
    nms_bev_batched``), one (sel, sel_valid) per entry in entry order,
    while it is entered."""

    def __enter__(self):
        from virconv_tpu_torch.ops import boxes
        self._boxes, self._orig = boxes, boxes.nms_bev_batched
        self.calls = []

        def record(*a, **k):
            out = self._orig(*a, **k)
            self.calls += zip(*(t.detach().cpu() for t in out))
            return out
        boxes.nms_bev_batched = record
        return self

    def __exit__(self, *exc):
        self._boxes.nms_bev_batched = self._orig
        return False


def replay_nms(rank, world, payload):
    """A ``step_rank`` setup: the rank's NMS calls return the one-process
    step's selections of its entries (``payload['nms']``, one per global
    entry), in order."""
    import torch
    from virconv_tpu_torch.ops import boxes
    calls = payload['nms']
    per = len(calls) // world
    queue = list(calls[rank * per:(rank + 1) * per])

    def replay(boxes_, *a, **k):
        entries = [queue.pop(0) for _ in range(boxes_.shape[0])]
        return tuple(torch.stack(t).to(boxes_.device)
                     for t in zip(*entries))
    boxes.nms_bev_batched = replay


def _one_process_step(make_cfg, device, batch, draws, prepare=None):
    """A fresh seeded ``Trainer``'s first step on ``batch`` with ``draws``
    (its loss, gradients, parameters, buffers and capacity caps), then a
    second, timed (ms, peak GiB); and the weights it started from.
    ``prepare(model)`` edits the weights first."""
    import torch
    from virconv_tpu_torch.ops import sparse
    from virconv_tpu_torch.train.trainer import Trainer
    cuda = device == 'cuda'
    with torch.enable_grad():
        trainer = Trainer(make_cfg(), device=device, seed=0)
        if prepare is not None:
            prepare(trainer.model)
        state_dict = {k: v.detach().cpu().clone() for k, v in
                      trainer.model.state_dict().items()}
        sparse.CAP_LOG = []
        with NmsRecord() as nms:
            loss, _ = trainer.step(batch, draws)
        caps, sparse.CAP_LOG = sparse.CAP_LOG, None
        model = trainer.model
        one = {'loss': float(loss), 'caps': caps, 'nms': nms.calls,
               'grads': {n: p.grad.detach().cpu() for n, p in
                         model.named_parameters() if p.grad is not None},
               'params': {n: p.detach().cpu().clone() for n, p in
                          model.named_parameters()},
               'buffers': {n: b.detach().cpu().clone() for n, b in
                           model.named_buffers()},
               'lr0': float(trainer.optimizer.lr_fn(0))}
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        trainer.step(batch)
        if cuda:
            torch.cuda.synchronize()
        one['ms'] = (time.perf_counter() - t) * 1e3
        one['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if cuda else 0.0
        del trainer, model
        if cuda:
            torch.cuda.empty_cache()
    return one, state_dict


def _dropped(caps):
    return [(site, cap, rows) for site, cap, rows in caps if rows > cap]


def dp_equality(make_cfg, device, batch, entries_per_frame):
    """One step of ``make_cfg``'s model on ``batch``, its box-regression
    outputs zeroed: the one-process ``Trainer`` with draws from a seeded
    generator, then 2 ranks on one card over gloo (``parallel.spawn.
    step_rank``) from the same weights, each on its frames, with those
    draws mapped to it (``Draws.for_rank``) and the one process's NMS
    selections replayed (``replay_nms``), twice; then one rank in an nccl
    group of its own (gloo on the CPU) once. Returns the comparison."""
    import torch
    from virconv_tpu_torch.parallel.spawn import run_ranks, step_rank
    from virconv_tpu_torch.train.draws import Draws
    cuda = device == 'cuda'
    draws = Draws(torch.Generator(device=device).manual_seed(11))
    one, state_dict = _one_process_step(make_cfg, device, batch, draws,
                                        zero_box_outputs)
    payload = {'cfg': make_cfg(), 'state_dict': state_dict,
               'batch': batch, 'device': 'cuda:0' if cuda else 'cpu',
               'seed': 0, 'entries_per_frame': entries_per_frame,
               'draws': [draws.for_rank(r, DP_WORLD)
                         for r in range(DP_WORLD)],
               'setup': replay_nms, 'nms': one['nms']}
    ranks, again = (run_ranks(step_rank, DP_WORLD, payload, timeout=600,
                              threads=4) for _ in range(2))
    lr0 = one['lr0']
    grad = max(_grad_worst(r['grads'], one['grads']) for r in ranks)
    norm_floor = 1e-4 * max(float(g.norm()) for g in one['grads'].values())
    out = {
        'loss_one_process': one['loss'],
        'loss_ranks': [r['loss'] for r in ranks],
        'loss_rel_err': max(abs(r['loss'] - one['loss']) / abs(one['loss'])
                            for r in ranks),
        'worst_grad': list(grad),
        'worst_grad_norm_rel': list(max(
            (float((r['grads'][n] - g).norm()) / max(float(g.norm()),
                                                      norm_floor), n)
            for r in ranks for n, g in one['grads'].items())),
        'worst_param_over_tol': list(max(
            _worst_over(r['params'], one['params'], 3 * lr0, 1e-3)
            for r in ranks)),
        'worst_bn_stat_over_tol': list(max(
            _worst_over(r['buffers'], one['buffers'], 2e-4, 1e-2)
            for r in ranks)),
        'ranks_bit_equal': _bits(ranks[0]['params'], ranks[1]['params'])
        and _bits(ranks[0]['buffers'], ranks[1]['buffers']),
        'repeat_bit_equal': all(
            _bits(a[k], b[k]) for a, b in zip(ranks, again)
            for k in ('params', 'buffers', 'grads'))
        and all(a['loss'] == b['loss'] for a, b in zip(ranks, again)),
        'dropped_rows_per_rank': [_dropped(r['caps']) for r in ranks],
        'dropped_rows_one_process': _dropped(one['caps']),
        'launches_per_rank': [r['steps'][0]['launches'] for r in ranks]}
    solo = run_ranks(step_rank, 1, {
        **payload, 'draws': [draws.for_rank(0, 1)]},
        backend='nccl' if cuda else 'gloo', timeout=600, threads=4)[0]
    out['nccl_world1_bit_equal'] = {
        **{k: _bits(solo[k], one[k]) for k in ('grads', 'params', 'buffers')},
        'loss': solo['loss'] == one['loss']}
    return out


def _equality_line(eq):
    return (f'loss {eq["loss_ranks"]} vs {eq["loss_one_process"]!r} (rel '
            f'{eq["loss_rel_err"]:.3g}, tol 1e-4), worst gradient '
            f'{eq["worst_grad"][1]} at {eq["worst_grad"][0]:.3g} x its '
            f'scale (norm {eq["worst_grad_norm_rel"][0]:.3g} of its norm, '
            f'{eq["worst_grad_norm_rel"][1]}), worst parameter '
            f'{eq["worst_param_over_tol"][1]} at '
            f'{eq["worst_param_over_tol"][0]:.3g} of its tolerance (3 lr0 + '
            f'1e-3 rel), worst BN statistic {eq["worst_bn_stat_over_tol"][1]} '
            f'at {eq["worst_bn_stat_over_tol"][0]:.3g} of its tolerance (2e-4 '
            f'+ 1e-2 rel); ranks bit-equal {eq["ranks_bit_equal"]}, second '
            f'run bit-equal {eq["repeat_bit_equal"]}; rows dropped by a cap '
            f'per rank {eq["dropped_rows_per_rank"]} (one process '
            f'{eq["dropped_rows_one_process"]}); launches per rank '
            f'{eq["launches_per_rank"]}')


def _gate_equality(eq, name, launches=True):
    """Phase 14a's gates on ``dp_equality``'s comparison. Gradients: each
    parameter's within 1e-2 of its norm (floored at 1e-4 x the step's
    largest norm). Phase 7's rule (each entry within 1e-3 x the
    parameter's largest) cannot hold here: f32 round-off of the halved
    sums crosses ReLU kinks of a full-width step (PERF.md §6), each of
    which moves a single gradient row; the worst entry is printed."""
    if launches:
        for r in eq['launches_per_rank']:
            for k in ('band_conv_fwd', 'band_conv_dw', 'gather_rows_bwd'):
                if not r[k]:
                    fail(f'{name}: {k} was never launched on a rank')
    if any(eq['dropped_rows_per_rank']) or eq['dropped_rows_one_process']:
        fail(f'{name}: a capacity cap dropped rows')
    grad_ok = eq['worst_grad_norm_rel'][0] <= 1e-2
    if not (eq['loss_rel_err'] <= 1e-4 and grad_ok
            and eq['worst_param_over_tol'][0] <= 1
            and eq['worst_bn_stat_over_tol'][0] <= 1):
        fail(f'{name}: the 2-rank step is not the one-process step')
    if not eq['ranks_bit_equal']:
        fail(f'{name}: the ranks hold different parameters after the step')
    if not eq['repeat_bit_equal']:
        fail(f'{name}: a second 2-rank run gave other bits')
    if not all(eq['nccl_world1_bit_equal'].values()):
        fail(f'{name}: the nccl group of one differs from no group: '
             f'{eq["nccl_world1_bit_equal"]}')


def dp_step_phase(card, tag='phase 14', device='cuda', make_cfg=None,
                  batch=None, full_batch=None):
    """Phase 14a and 14b. The equality run (``dp_equality``): full-width
    VirConv-T on ``dp_batch()`` (no cap binds), a frame (3 entries) per
    rank, with the nccl group of one. The timing run, on phase 6's whole
    batch: 3 steps of 2 ranks with their own draws, the second timed, the
    third's collectives timed, against a warm one-process step, and the
    rows each cap drops per rank. ``device``, ``make_cfg``, ``batch`` and
    ``full_batch`` let a CPU rehearsal run it (gloo for the group of
    one)."""
    from virconv_tpu_torch.parallel.spawn import run_ranks, step_rank
    from virconv_tpu_torch.utils.bench_inputs import train_batch
    make_cfg = make_cfg or virconv_t_cfg
    batch = dp_batch() if batch is None else batch
    full_batch = train_batch() if full_batch is None else full_batch
    eq = dp_equality(make_cfg, device, batch,
                     make_cfg().MODEL.ROI_HEAD.ROT_NUM)
    one_full, full_state = _one_process_step(make_cfg, device, full_batch,
                                             None)
    t = time.perf_counter()
    full = run_ranks(step_rank, DP_WORLD, {
        'cfg': make_cfg(), 'state_dict': full_state, 'batch': full_batch,
        'device': 'cuda:0' if device == 'cuda' else 'cpu', 'seed': 0,
        'entries_per_frame': make_cfg().MODEL.ROI_HEAD.ROT_NUM,
        'steps': len(DP_TIMING), 'timing': DP_TIMING}, timeout=600,
        threads=4)
    full_s = time.perf_counter() - t
    # the timing run: each rank's warm second step, and the collectives
    # of its third
    warm = [r['steps'][1] for r in full]
    coll = full[0]['steps'][2]['collectives']
    report = {
        'card': card, 'world': DP_WORLD, 'backend': 'gloo',
        'entries_per_rank': batch['points'].shape[0] // DP_WORLD,
        'crop': {k: list(v) for k, v in DP_CROP.items()},
        'valid_points': [int(batch['points_valid'].sum()),
                         int(batch['points_mm_valid'].sum())],
        'equality': eq,
        'one_process_step_ms': one_full['ms'],
        'one_process_peak_gib': one_full['peak_gib'],
        'rank_step_ms': [w['seconds'] * 1e3 for w in warm],
        'rank_first_step_ms': [r['steps'][0]['seconds'] * 1e3
                               for r in full],
        'rank_timed_step_ms': [r['steps'][2]['seconds'] * 1e3
                               for r in full],
        'rank_peak_gib': [(w['peak_bytes'] or 0) / 2 ** 30 for w in warm],
        'grad_allreduce': {'calls': coll['grads']['calls'],
                           'bytes': coll['grads']['bytes'],
                           'ms': coll['grads']['seconds'] * 1e3},
        'sync_bn': {'calls': coll['moments']['calls'],
                    'bytes': coll['moments']['bytes'],
                    'ms': coll['moments']['seconds'] * 1e3},
        'counts': {'calls': coll['counts']['calls'],
                   'ms': coll['counts']['seconds'] * 1e3},
        'timing_run_s': full_s,
        'dropped_rows_full_batch_per_rank': [_dropped(r['caps'])
                                             for r in full],
        'dropped_rows_full_batch_one_process': _dropped(one_full['caps']),
        'launches_full_batch_per_rank': [r['steps'][0]['launches']
                                         for r in full]}
    print(f'[{tag}a] card "{card}" (a one-card gloo rehearsal: 2 ranks '
          f'share cuda:0; nothing here measures NCCL over NVLink): '
          f'VirConv-T on phase 6\'s batch, {report["entries_per_rank"]} '
          f'entries per rank: warm step ms per rank '
          f'{report["rank_step_ms"]} vs one process {one_full["ms"]:.1f}; '
          f'gradient all-reduce {json.dumps(report["grad_allreduce"])}; '
          f'sync-BN all-reduces per step {json.dumps(report["sync_bn"])}; '
          f'count all-reduces {json.dumps(report["counts"])}; peak GiB per '
          f'rank {report["rank_peak_gib"]} vs one process '
          f'{one_full["peak_gib"]:.2f}; rows dropped by a cap per rank '
          f'{report["dropped_rows_full_batch_per_rank"]} (one process '
          f'{report["dropped_rows_full_batch_one_process"]})', flush=True)
    print(f'[{tag}a] full width, phase 6\'s batch within x, y boxes '
          f'{report["crop"]} m ({report["valid_points"]} valid points), box '
          f'outputs zeroed, NMS replayed: {_equality_line(eq)}', flush=True)
    print(f'[{tag}b] one rank in an nccl group of its own vs the trainer '
          f'without a group, bit for bit: {eq["nccl_world1_bit_equal"]}',
          flush=True)
    _gate_equality(eq, 'full width', launches=device == 'cuda')
    for r in report['launches_full_batch_per_rank']:
        if device == 'cuda' and not (r['band_conv_fwd']
                                     and r['band_conv_dw']):
            fail('a kernel was never launched in the timing run')
    if not all(np.isfinite(s['loss']) for r in full for s in r['steps']):
        fail('a non-finite loss in the timing run')
    return report


def virconv_t_cfg():
    from virconv_tpu_torch.config import virconv_t_config
    return virconv_t_config()


def dp_cli_phase(tmp, logger, card, tag='phase 14', device='cuda',
                 cfg=None):
    """Phase 14c and 14d: ``tools/test_gpu.py --launcher pytorch`` with 2
    ranks over phase 9's scene tree and checkpoint against one process's
    ``eval_one_ckpt`` with per-frame streams; ``tools/train_gpu.py
    --launcher pytorch`` with 2 ranks for one epoch on phase 10's tree
    (global batch 2, a frame per rank) and its distributed evaluation.
    ``device`` and ``cfg`` (for both CLIs) let a CPU rehearsal run it."""
    from virconv_tpu_torch.parallel.fullwidth import compare_preds
    from virconv_tpu_torch.parallel.spawn import run_ranks
    from virconv_tpu_torch.train.eval_loop import eval_one_ckpt
    root = tmp / 'scene'
    eval_cfg = cfg or virconv_t_cfg()
    eval_cfg.DATA_CONFIG.DATA_PATH = str(root)
    ckpt = tmp / 'ckpt_full_VirConv8x' / 'checkpoint_epoch_1.pth'
    one = eval_one_ckpt(eval_cfg, ckpt, logger, tmp / 'dp_eval_one',
                        device=device, seed=1024, frame_streams=True)
    common = ['--cfg', 'virconv_t', '--device',
              'cuda:0' if device == 'cuda' else 'cpu', '--launcher',
              'pytorch', '--dist_backend', 'gloo']
    t = time.perf_counter()
    ranks = run_ranks(dp_cli_rank, DP_WORLD, ('test_gpu', common + [
        '--ckpt', str(ckpt), '--output_dir', str(tmp / 'dp_eval'), '--set',
        'DATA_CONFIG.DATA_PATH', str(root)], _free_port(), cfg),
        backend=None, timeout=600, threads=4)
    eval_s = time.perf_counter() - t
    got = ranks[0]['result']
    ok_rank1 = ranks[1]['result'] is None
    ids = [a['frame_id'] for a in got['det_annos']] if got else []
    cmp = compare_preds(got['det_annos'] if got else [], one.det_annos,
                        boxes='boxes_lidar', scores='score')
    counts, want_counts = cmp['detections'], cmp['one_process_detections']
    box, score = cmp['max_box_diff'], cmp['max_score_diff']
    ap = max((abs(got['result'][k] - v) for k, v in
              one.result_dict.items()), default=0.0) if got else None
    evaluation = {'frames': [got['frames'] if got else None],
                  'merged_frames': len(ids), 'detections': counts,
                  'one_process_detections': want_counts,
                  'max_box_diff': box, 'max_score_diff': score,
                  'max_ap_diff': ap, 'seconds': eval_s,
                  'launches_per_rank': [r['launches'] for r in ranks]}
    print(f'[{tag}c] tools/test_gpu.py --launcher pytorch, {DP_WORLD} '
          f'ranks on a scene tree of {len(one.det_annos)} frames: merged '
          f'{len(ids)} frames, detections {counts} vs one process '
          f'{want_counts}, max box diff {box}, score diff {score}, AP diff '
          f'{ap}, {eval_s:.1f} s, launches per rank '
          f'{evaluation["launches_per_rank"]} (card "{card}")', flush=True)
    if not (got and ok_rank1 and ids == [a['frame_id'] for a in
                                        one.det_annos]
            and counts == want_counts):
        fail('the merged distributed evaluation has other frames or '
             'detections than one process')
    if not (cmp['agree'] and ap <= 1e-4
            and got['result'].keys() == one.result_dict.keys()):
        fail('the merged distributed evaluation differs from one process')
    for r in ranks:
        if not (r['launches']['band_conv_fwd']
                and r['launches']['roi_pool_fwd']):
            fail(f'a rank of the distributed evaluation missed a kernel: '
                 f'{r["launches"]}')

    out = tmp / 'dp_train'
    t = time.perf_counter()
    ranks = run_ranks(dp_cli_rank, DP_WORLD, ('train_gpu', common + [
        '--batch_size', str(DP_WORLD), '--epochs', '1', '--output_dir',
        str(out), '--log_interval', '1', '--fix_random_seed', '--set',
        'DATA_CONFIG.DATA_PATH', str(tmp / 'train_scene')], _free_port(),
        cfg), backend=None, timeout=900, threads=4)
    train_s = time.perf_counter() - t
    r0, r1 = (r['result'] for r in ranks)
    files = sorted(p.name for p in (out / 'ckpt').iterdir())
    training = {'steps_per_rank': [len(r0['steps']), len(r1['steps'])],
                'loss': [[s['loss'] for s in r['steps']] for r in (r0, r1)],
                'ms_per_step': [[s['seconds'] * 1e3 for s in r['steps']]
                                for r in (r0, r1)],
                'checkpoints': [r0['checkpoints'], r1['checkpoints']],
                'ckpt_files': files,
                'eval_frames': r0['eval']['frames'] if r0['eval'] else None,
                'seconds': train_s,
                'launches_per_rank': [r['launches'] for r in ranks]}
    print(f'[{tag}d] tools/train_gpu.py --launcher pytorch, {DP_WORLD} '
          f'ranks, one epoch: steps {training["steps_per_rank"]}, loss '
          f'{training["loss"]}, ms/step {training["ms_per_step"]}, '
          f'checkpoints by rank {training["checkpoints"]}, files {files}, '
          f'distributed evaluation of {training["eval_frames"]} frames on '
          f'rank 0, {train_s:.1f} s, launches per rank '
          f'{training["launches_per_rank"]} (card "{card}")', flush=True)
    losses = training['loss']
    if not (losses[0] and losses[0] == losses[1]
            and all(np.isfinite(losses[0]))):
        fail('the ranks of the training CLI logged other or non-finite '
             'losses')
    if not (r0['checkpoints'] == ['checkpoint_epoch_1.pth']
            and r1['checkpoints'] == [] and files == r0['checkpoints']):
        fail(f'checkpoints {training["checkpoints"]}, files {files}')
    if not (r0['eval'] and set(r0['eval']['result']) == R40_KEYS
            and r1['eval'] is None):
        fail('the distributed evaluation after training did not finish')
    for r in ranks:
        if not (r['launches']['band_conv_fwd']
                and r['launches']['band_conv_dw']):
            fail(f'a rank of the training CLI missed a kernel: '
                 f'{r["launches"]}')
    return evaluation, training


# ---- phase 15: the JAX package's routing switches --------------------------

# (name, switches) of the eval routes phase 15 drives besides the default
T_ROUTES = (('band_off', {'VIRCONV_BAND': '0'}),
            ('band2d_off', {'VIRCONV_BAND2D': '0'}),
            ('dense2d', {'VIRCONV_DENSE2D': '1'}),
            ('pool_kernel_off', {'VIRCONV_POOL_KERNEL': '0'}),
            ('pool_tile', {'VIRCONV_POOL_TILE': '1'}))
L_ROUTES = T_ROUTES[:3]
ROUTE_REQUESTS = 2


class RouteCapture:
    """Records one forward's ``nmap_conv`` launches (inputs) and its ROI
    pooling plans, each with the queries of the SA call that built it (the
    calls still run)."""

    def __enter__(self):
        from virconv_tpu_torch.models.roi_heads import voxel_pool
        from virconv_tpu_torch.ops import nmap_conv, roi_pool
        self.nmap, self.plans = [], []
        self._mods = (nmap_conv, roi_pool, voxel_pool.NeighborVoxelSAModule)
        self._orig = (nmap_conv._nmap_conv_cuda, roi_pool.roi_pool_plan,
                      voxel_pool.NeighborVoxelSAModule.forward)
        orig_nm, orig_plan, orig_fwd = self._orig
        queries = [None]

        def nm(feats, nmap, weights):
            self.nmap.append((feats, nmap, weights))
            return orig_nm(feats, nmap, weights)

        def plan(*a, **k):
            p = orig_plan(*a, **k)
            self.plans.append((p, a, queries[0]))
            return p

        def fwd(mod, st, stride, qx, qc, qm, table_fn=None, q_per_roi=None,
                bf16=True):
            queries[0] = (qx, qc, qm, q_per_roi)
            return orig_fwd(mod, st, stride, qx, qc, qm, table_fn,
                            q_per_roi, bf16)
        nmap_conv._nmap_conv_cuda, roi_pool.roi_pool_plan = nm, plan
        self._mods[2].forward = fwd
        return self

    def __exit__(self, *exc):
        nc, rp, sa = self._mods
        nc._nmap_conv_cuda, rp.roi_pool_plan, sa.forward = self._orig
        return False


def fragment_products(nmap):
    """(fragment, tap) work of one ``nmap_conv`` tile-mode call per
    (row, tap) hit, counted from the map: the previous body multiplies a
    16-row fragment of its 64-row CTA by W[k] whenever any of the 16 rows
    hits tap k; the redesign multiplies ceil(hits / 16) compacted fragments
    per (CTA, tap). Returns (previous rows per hit, redesign's rows per
    hit)."""
    import torch
    hit = nmap >= 0
    n, k = hit.shape
    hits = int(hit.sum())
    if not hits:
        return 0.0, 0.0
    pad = -n % 64
    cta = torch.nn.functional.pad(hit, (0, 0, 0, pad)).reshape(-1, 64, k)
    prev = 16 * int(cta.reshape(-1, 4, 16, k).any(2).sum())
    new = 16 * int(((cta.sum(1) + 15) // 16).sum())
    return prev / hits, new / hits


def check_nmap_case(name, args, tag='phase 15'):
    """One ``nmap_conv`` call (eval under ``VIRCONV_BAND=0``, ``BAND2D=0``;
    training forward and input gradient) against its plain version (1e-4 x
    scale) and bit for bit against its previous body (``nmap_conv_prev``);
    kernel, previous-body and plain times, the (fragment, tap) rows each
    body multiplies per hit (``fragment_products``), and the bound:
    features, map and weights read once, the output written once, 2 C C'
    operations per (row, tap) hit at the f32 peak."""
    from virconv_tpu_torch.ops import gather_conv as gc
    from virconv_tpu_torch.ops import nmap_conv as nc
    feats, nmap, w = args
    k, c_in, c_out = w.shape
    got = nc.nmap_conv(feats, nmap, w)
    want = nc.nmap_conv_plain(feats, nmap, w)
    err = float((got - want).abs().max()) if want.numel() else 0.0
    tol = 1e-4 * max(1.0, float(want.abs().max()) if want.numel() else 0.0)
    if not err <= tol:
        fail(f'nmap_conv {name}: max err {err} > {tol}')
    if not bits_equal(got, nc.nmap_conv_prev(feats, nmap, w)):
        fail(f'[{tag}] nmap_conv {name}: the redesigned body differs from '
             'the previous one')
    hits = int((nmap >= 0).sum())
    mode = gc.kernel_mode(c_in, c_out)
    prev_rows, new_rows = fragment_products(nmap) if mode == 'tile' \
        else (None, None)
    line = {'case': name, 'rows_in': feats.shape[0],
            'rows_out': nmap.shape[0], 'c_in': c_in, 'c_out': c_out,
            'taps': k, 'mode': mode, 'max_abs_err_f32': err,
            'bit_equal_prev': True,
            'prev_rows_per_hit': prev_rows, 'rows_per_hit': new_rows,
            'ms': cuda_ms(lambda: nc.nmap_conv(feats, nmap, w)),
            'prev_ms': cuda_ms(lambda: nc.nmap_conv_prev(feats, nmap, w)),
            'plain_ms': cuda_ms(lambda: nc.nmap_conv_plain(feats, nmap, w),
                                reps=3, warmup=1),
            'taps_hit': hits,
            'bytes': nbytes(feats, nmap, w) + nmap.shape[0] * c_out * 4,
            'ops': 2.0 * hits * c_in * c_out}
    bound(line, F32_FLOPS)
    return line


def check_tiled_pool(name, args, record):
    """One quadrant-tiled K2+K3 call (``VIRCONV_POOL_TILE=1``): as phase 2
    against its plain version (``check_pool_case``), then un-tiled against
    the untiled call on the same SA inputs (its plan built with room for
    every block), bit for bit by int32 view."""
    import torch
    from virconv_tpu_torch.models.roi_heads import voxel_pool
    from virconv_tpu_torch.ops import roi_pool as rp
    plan, fg, w_eff, b_eff, specs, vs, stride, pcr = args
    _, plan_args, (qx, qc, qm, q) = record
    line = check_pool_case(name, args, bf16_timed=False)
    g = round(q ** (1.0 / 3.0))
    _, _, inv, qp = voxel_pool._tile_layout(g)
    r0 = qx.shape[0] // q
    st, ranges = plan_args[0], plan_args[5]
    full = rp.roi_pool_plan(st, qx, qc, qm, q, ranges, vs, stride, pcr,
                            nblk_cap=64 * r0 + 64)
    if not bool(full.ok):
        fail(f'roi_pool tiled {name}: the untiled plan overflowed')
    untiled = rp.roi_pool_apply(full, fg, w_eff, b_eff, specs, vs, stride,
                                pcr, False)
    tiled = rp.roi_pool_apply(plan, fg, w_eff, b_eff, specs, vs, stride,
                              pcr, False)
    n_g, _, mid = tiled.shape
    tiled = tiled.reshape(n_g, r0, 4 * qp, mid)[
        :, :, torch.as_tensor(inv, device=tiled.device)].reshape(
            n_g, r0 * q, mid)
    line['bit_equal'] = bits_equal(tiled, untiled)
    line['untiled_blocks'] = int(full.blk_start[-1])
    if not line['bit_equal']:
        fail(f'roi_pool tiled {name}: un-tiled output differs from the '
             f'untiled call in {int((tiled != untiled).sum())} values')
    return line


def _stream_tensors(raw):
    bb = raw['backbone']
    for stream in ('multi_scale_3d_features', 'multi_scale_3d_features_mm'):
        for k, st in bb.get(stream, {}).items():
            yield f'{stream}.{k}', st
    yield 'encoded_spconv_tensor', bb['encoded_spconv_tensor']


def route_diffs(raw, ref, name):
    """Gates a route's raw outputs against the default route's: every
    stream's coords and masks equal, its features within 1e-4 x their
    scale; the final ROI valid sets equal and the boxes within 1e-3, or,
    where they differ, every ROI matched ROI by ROI
    (``matched_roi_diffs``) with boxes within 1e-3. Returns the diffs."""
    import torch
    worst = 0.0
    ref_streams = dict(_stream_tensors(ref))
    for key, st in _stream_tensors(raw):
        want = ref_streams[key]
        if not (torch.equal(st.coords, want.coords)
                and torch.equal(st.mask, want.mask)):
            fail(f'route {name}: {key} coords or masks differ')
        scale = max(1.0, float(want.feats.float().abs().max()))
        err = float((st.feats.float() - want.feats.float()).abs().max())
        worst = max(worst, err / scale)
        if not err <= 1e-4 * scale:
            fail(f'route {name}: {key} features {err} > 1e-4 x {scale}')
    out = {'stream_max_err_over_scale': worst}
    valid, valid_ref = raw['roi_valid'], ref['roi_valid']
    if torch.equal(valid, valid_ref):
        box = float((raw['batch_box_preds'] - ref['batch_box_preds'])[
            valid].abs().max()) if bool(valid.any()) else 0.0
        out['box_max_abs_diff'] = box
        if box <= 1e-3:
            return out
    m = matched_roi_diffs(raw, ref)
    out['roi_by_roi'] = m
    print(f'[phase 15] {name}: ROIs by position differ, ROI by ROI '
          f'{json.dumps(m)}', flush=True)
    if not (m['rois_matched'] == m['rois_ref'] == int(valid.sum())
            and m['matched_box_preds_max_abs_diff'] <= 1e-3):
        fail(f'route {name}: final ROIs differ from the default route')
    return out


def route_run(det, frames, model, name, env, ref):
    """One eval route of ``det`` under ``env``: a captured forward (its
    ``nmap_conv`` and K2+K3 inputs, peak memory) gated against the default
    route's ``ref`` (``route_diffs``), then ROUTE_REQUESTS requests with
    every launch count and branch count set to 0 just before and read just
    after. Returns (the route's numbers, the captured forward's raw
    outputs, its ``RouteCapture`` and ``Capture``)."""
    import torch
    from virconv_tpu_torch.models.roi_heads import voxel_pool
    from virconv_tpu_torch.ops import band_conv, nmap_conv, roi_pool, sparse
    with Switches(**env):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with RouteCapture() as rc, Capture() as cap:
            raw = det.forward(frames)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        band_conv.launches = band_conv.patch_launches = 0
        roi_pool.launches = nmap_conv.launches = 0
        sparse.branch_counts.clear()
        voxel_pool.branch_counts.clear()
        times = []
        for _ in range(ROUTE_REQUESTS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = det(frames)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        launches = {'band_conv_fwd': band_conv.launches,
                    'band_conv_patch': band_conv.patch_launches,
                    'roi_pool_fwd': roi_pool.launches,
                    'nmap_conv_fwd': nmap_conv.launches}
        convs, pools = dict(sparse.branch_counts), dict(
            voxel_pool.branch_counts)
    if not all(np.isfinite(r['boxes']).all() for r in res):
        fail(f'{model} route {name}: non-finite detections')
    line = {'switches': env, 'ms_per_request': times,
            'launches': launches, 'conv_branches': convs,
            'pool_branches': pools, 'peak_gib': peak}
    if ref is not None:
        line.update(route_diffs(raw, ref, f'{model} {name}'))
    print(f'[phase 15] {model} route {name} {json.dumps(env)}: '
          f'{json.dumps(line)}', flush=True)
    return line, raw, rc, cap


def route_gates(model, name, line, n_calls):
    """The launches a route must show over its ROUTE_REQUESTS requests."""
    ln, convs, pools = (line[k] for k in ('launches', 'conv_branches',
                                          'pool_branches'))
    if convs.get('nmap_slow'):
        fail(f'{model} {name}: a band context left the band kernel')
    if name == 'band_off' and (convs.get('band') or ln['band_conv_fwd']
                               or ln['nmap_conv_fwd'] != convs.get('nmap')
                               or ln['nmap_conv_fwd'] != n_calls
                               * ROUTE_REQUESTS):
        fail(f'{model} band_off: not every eval conv on nmap_conv: {ln}, '
             f'{convs}')
    if name == 'band2d_off' and not (convs.get('band') and convs.get('nmap')
                                     == ln['nmap_conv_fwd'] > 0):
        fail(f'{model} band2d_off: {ln}, {convs}')
    if name == 'dense2d' and (convs.get('nmap') or not convs.get('band')):
        fail(f'{model} dense2d: {convs}')
    if name == 'pool_kernel_off' and (ln['roi_pool_fwd']
                                      or 'kernel' in pools):
        fail(f'{model} pool_kernel_off: {ln}, {pools}')
    if name == 'pool_tile' and not any(
            k.startswith('kernel tiled') for k in pools):
        fail(f'{model} pool_tile: no tiled K2+K3 launch: {pools}')


def routes_for(det, frames, model, routes):
    """The default route, then each of ``routes``, of one f32 detector.
    Returns (numbers by route, nmap_conv lines of band_off, tiled K2+K3
    lines, their launches)."""
    import torch
    out, nmap_lines, tiled_lines, counts = {}, [], [], {}
    out['default'], ref, _, _ = route_run(det, frames, model, 'default', {},
                                          None)
    for name, env in routes:
        line, raw, rc, cap = route_run(det, frames, model, name, env, ref)
        route_gates(model, name, line, len(rc.nmap))
        if name in ('band_off', 'band2d_off'):
            lines = [check_nmap_case(f'{i:02d} k{a[2].shape[0]}', a)
                     for i, a in enumerate(rc.nmap)]
            line['nmap_conv'] = summed(lines)
            print(f'[phase 15] {model} {name}: {len(lines)} nmap_conv '
                  f'calls per request vs plain, {json.dumps(summed(lines))}',
                  flush=True)
            if name == 'band_off' and model == 'VirConv-T':
                nmap_lines = lines
                counts['nmap_conv_fwd'] = line['launches']['nmap_conv_fwd']
        if name == 'pool_tile':
            records = {id(r[0]): r for r in rc.plans}
            for i, a in enumerate(cap.pool):
                rec = records[id(a[0])]
                if rec[2][3] == a[0].q_per_roi:       # an untiled call
                    continue
                tl = check_tiled_pool(f'{i} stride{a[6]}_q{a[0].q_per_roi}',
                                      a, rec)
                tiled_lines.append(tl)
                print(f'[phase 15] {model} roi_pool tiled {short(tl)}',
                      flush=True)
            if not tiled_lines:
                fail(f'{model} pool_tile: no tiled K2+K3 call captured')
            line['roi_pool_tiled'] = summed(tiled_lines)
            counts['roi_pool_fwd_tiled'] = sum(
                v for k, v in line['pool_branches'].items()
                if k.startswith('kernel tiled'))
        out[name] = line
        del raw, rc, cap
    del ref
    torch.cuda.empty_cache()
    return out, nmap_lines, tiled_lines, counts


def _sorted_rows(st):
    """(keys, feats) of the valid rows in key order."""
    import torch
    keys = st.keys()
    order = torch.argsort(keys)
    n = int(st.mask.sum())
    return keys[order][:n], st.feats[order][:n].float()


def stacks_close(got, want, label):
    """LidarStack outputs (dense tail against sparse): x_conv1-2 the same
    rows, x_conv3, x_conv4 and ``out`` the same sites (compared in key
    order: the dense tail's rows come in scan order), features within
    1e-4 x their scale. Returns the worst error over its scale."""
    import torch
    worst = 0.0
    for k in ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4', 'out'):
        kg, fg = _sorted_rows(got[k])
        kw, fw = _sorted_rows(want[k])
        if not torch.equal(kg, kw):
            fail(f'{label}: {k} sites differ ({kg.numel()} vs {kw.numel()})')
        scale = max(1.0, float(fw.abs().max()))
        err = float((fg - fw).abs().max()) if fw.numel() else 0.0
        worst = max(worst, err / scale)
        if not err <= 1e-4 * scale:
            fail(f'{label}: {k} features {err} > 1e-4 x {scale}')
    return worst


def dense_tail_phase(det, frames, tag='phase 15'):
    """``LidarStack(dense_tail=True)`` on the request's LiDAR stream (6
    entries) with the VirConv-T stack's weights, against the sparse stack:
    at eval (f32 operands, TF32 off), then one training forward and
    backward of each (the loss a fixed random projection of every output,
    summed over rows): outputs as ``stacks_close``, the loss within rel
    1e-4, every gradient within 1e-2 of its norm (phase 14's rule: a
    pre-activation within round-off of ReLU's kink moves single entries
    by more than phase 7's 1e-3 x scale, which is printed), every BN
    statistic within 1e-4 x its scale. Times and peak memory of each."""
    import torch
    from virconv_tpu_torch.models.backbones_3d.virconv import LidarStack
    model = det.model
    batch = det.make_batch(frames)
    st = model.voxelize(batch['points'], batch['points_valid'],
                        batch['points'].shape[0], model.indicator_max)
    src = model.backbone.lidar
    nf = tuple(getattr(src, f'conv{i}').kernel.shape[2]
               for i in ('1', '2_a', '3_a', '4_a'))
    dims = (src.conv_input.kernel.shape[1], nf,
            src.conv_out.kernel.shape[2], src.cap_ratios)
    dev = st.feats.device
    stacks = {}
    for dense in (False, True):
        s = LidarStack(*dims, dense_tail=dense).to(dev)
        s.load_state_dict(src.state_dict())
        stacks[dense] = s
    res = {'rows_in': int(st.mask.sum()), 'spatial_shape': st.spatial_shape}
    outs = {}
    for train in (False, True):
        gen = torch.Generator(device=dev).manual_seed(15)
        proj = {k: torch.randn(c, generator=gen, device=dev)
                for k, c in (('x_conv1', nf[0]), ('x_conv2', nf[1]),
                             ('x_conv3', nf[2]), ('x_conv4', nf[3]),
                             ('out', dims[2]))}
        for dense, s in stacks.items():
            s.train(train)
            s.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            with torch.set_grad_enabled(train):
                o = s(st, bf16=False)
                loss = sum((o[k].feats * proj[k]).sum() for k in proj)
                if train:
                    loss.backward()
            torch.cuda.synchronize()
            key = (f'{"train" if train else "eval"}_'
                   f'{"dense" if dense else "sparse"}')
            res[f'{key}_ms'] = (time.perf_counter() - t) * 1e3
            res[f'{key}_peak_gib'] = (torch.cuda.max_memory_allocated()
                                      / 2 ** 30)
            outs[dense] = (o, float(loss))
        label = f'dense tail ({"train" if train else "eval"})'
        mode = 'train' if train else 'eval'
        res[f'{mode}_max_err_over_scale'] = stacks_close(
            outs[True][0], outs[False][0], label)
        l_d, l_s = outs[True][1], outs[False][1]
        res[f'{mode}_loss'] = [l_s, l_d]
        if not abs(l_d - l_s) <= 1e-4 * abs(l_s):
            fail(f'{label}: loss {l_d!r} vs sparse {l_s!r}')
        del outs[True], outs[False]
    grads = {d: {n: p.grad.detach() for n, p in s.named_parameters()
                 if p.grad is not None} for d, s in stacks.items()}
    res['grad_worst_over_scale'] = _grad_worst(grads[True], grads[False])
    norm, name = _grad_norm_worst(grads[True], grads[False])
    res['grad_worst_over_norm'] = [norm, name]
    if set(grads[True]) != set(grads[False]) or not norm <= 1e-2:
        fail(f'dense tail gradients: {norm} of the norm at {name}')
    bufs = {d: dict(s.named_buffers()) for d, s in stacks.items()}
    bn = max(float((bufs[True][n] - b).abs().max())
             / max(float(b.abs().max()), 1e-6)
             for n, b in bufs[False].items() if b.is_floating_point())
    res['bn_stats_max_err_over_scale'] = bn
    if not bn <= 1e-4:
        fail(f'dense tail BN statistics: {bn} x scale')
    print(f'[{tag}] VirConv-T LiDAR stack, dense tail vs sparse: '
          f'{json.dumps(res)}', flush=True)
    del stacks, grads, bufs
    torch.cuda.empty_cache()
    return res


def _grad_norm_worst(got, want):
    """(the worst |got - want| / |want| over the parameters, in L2 norm,
    each norm floored at 1e-4 x the largest: phase 14's rule; gradients
    that are zero in exact arithmetic are round-off), its parameter)."""
    floor = 1e-4 * max(float(g.norm()) for g in want.values())
    return max((float((got[n] - g).norm()) / max(float(g.norm()), floor), n)
               for n, g in want.items())


class PreActivations:
    """Records every BN output of ``module`` in a forward (the
    ``MaskedBatchNorm`` rows of the sparse blocks, the pools and the heads,
    the ``FlaxBatchNorm2d`` maps of the BEV: what every ReLU of the model
    but the pools' reads), and the output of each module named in
    ``values``, by module name and call. With ``snap_to`` (another
    forward's records, on any device) each BN entry on the other side of
    ReLU's kink from the recorded one is moved onto the recorded value,
    and each output of ``values`` is replaced by the recorded one, its
    gradient passed through unchanged; ``moved`` keeps, per call of a
    ``values`` module, the largest move over the recorded output's
    scale."""

    def __init__(self, module, snap_to=None, values=()):
        import torch
        from virconv_tpu_torch.models.layers import (FlaxBatchNorm2d,
                                                     MaskedBatchNorm)
        self.rows, self.moved, self._hooks = {}, {}, []
        named = dict(module.named_modules())
        if any(n not in named for n in values):
            fail(f'PreActivations: no module {set(values) - set(named)}')

        def hook(m, args, out, name, bn):
            calls = sum(k.startswith(f'{name} #') for k in self.rows)
            key = f'{name} #{calls}'
            mask = None
            if bn:
                mask = args[1][:, None] if len(args) > 1 else \
                    torch.ones_like(out, dtype=torch.bool)
            self.rows[key] = (out.detach(), mask)
            if snap_to is None:
                return None
            ref = snap_to[key][0].to(out.device)
            if not bn:
                self.moved[key] = float((ref - out.detach()).abs().max()) \
                    / max(float(ref.abs().max()), 1e-30)
                return out + (ref - out).detach()
            flip = ((out > 0) != (ref > 0)) & mask
            return out + torch.where(flip, ref - out, 0.0).detach()
        for name, m in named.items():
            bn = isinstance(m, (MaskedBatchNorm, FlaxBatchNorm2d))
            if bn or name in values:
                self._hooks.append(m.register_forward_hook(
                    lambda m, a, out, name=name, bn=bn:
                    hook(m, a, out, name, bn)))

    def remove(self):
        for h in self._hooks:
            h.remove()


def sign_flips(a, b):
    """BN outputs on opposite sides of ReLU's kink in two forwards' records
    (``a``'s device): {module: (count, the largest |value| among them)}."""
    out = {}
    for name, (x, mask) in a.items():
        if mask is None:
            continue
        y = b[name][0].to(x.device)
        flip = ((x > 0) != (y > 0)) & mask
        if bool(flip.any()):
            out[name] = (int(flip.sum()), max(float(x[flip].abs().max()),
                                              float(y[flip].abs().max())))
    return out


def band_train_off_step(batch, tag='phase 15'):
    """One full-width VirConv-T training step's forward and backward from
    one seeded trainer with the same draws (no optimizer step), the
    box-regression outputs zeroed (``zero_box_outputs``) and the first
    pass's NMS selections replayed: (1) by default; (2) under
    ``VIRCONV_BAND_TRAIN=0``; (3) as (2) with every pre-activation
    (``MaskedBatchNorm`` output) that (2) put on the other side of ReLU's
    kink from (1) snapped to (1)'s value. Gates: K1 and K4 launched in
    (1) and not in (2), (2)'s loss within rel 1e-4 of (1)'s, and (3)'s
    gradients within 1e-3 x their scale of (1)'s (phase 7's rule): the
    round-off between the band conv and the neighbor-map conv moves (2)'s
    gradients further only through those sign changes, which are printed
    with (2)'s worst gradients. ms and peak memory of (1) and (2)."""
    import torch
    from virconv_tpu_torch.ops import band_conv, boxes, sparse
    from virconv_tpu_torch.train.draws import Draws
    from virconv_tpu_torch.train.trainer import Trainer, step_seed
    with torch.enable_grad():
        trainer = Trainer(device='cuda', seed=0)
        model = zero_box_outputs(trainer.model)
        batch = trainer.to_device(batch)
        res, passes, pre = {}, {}, {}
        calls = []
        for name, env in (('default', {}),
                          ('band_train_off', {'VIRCONV_BAND_TRAIN': '0'}),
                          ('band_train_off_snapped',
                           {'VIRCONV_BAND_TRAIN': '0'})):
            orig = boxes.nms_bev_batched
            if calls:
                queue = list(calls)
                boxes.nms_bev_batched = lambda *a, **k: queue.pop(0)
            else:
                def record(*a, **k):
                    out = orig(*a, **k)
                    calls.append(out)
                    return out
                boxes.nms_bev_batched = record
            rec = PreActivations(model, pre.get('default')
                                 if name.endswith('snapped') else None)
            try:
                with Switches(**env):
                    trainer.generator.manual_seed(step_seed(0, 0))
                    model.zero_grad(set_to_none=True)
                    band_conv.launches = band_conv.dw_launches = 0
                    sparse.branch_counts.clear()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t = time.perf_counter()
                    out = model(batch, rng=Draws(trainer.generator))
                    out['loss'].backward()
                    torch.cuda.synchronize()
            finally:
                boxes.nms_bev_batched = orig
                rec.remove()
            res[name] = {'ms': (time.perf_counter() - t) * 1e3,
                         'peak_gib': torch.cuda.max_memory_allocated()
                         / 2 ** 30, 'loss': float(out['loss'].detach()),
                         'k1_launches': band_conv.launches,
                         'k4_launches': band_conv.dw_launches,
                         'conv_branches': dict(sparse.branch_counts)}
            passes[name] = {n: p.grad.detach().clone() for n, p in
                            model.named_parameters() if p.grad is not None}
            pre[name] = rec.rows
            del out
    d, off = res['default'], res['band_train_off']
    if not (d['k1_launches'] and d['k4_launches']) or off['k1_launches'] \
            or off['k4_launches'] or any(k.startswith('band') for k in
                                         off['conv_branches']):
        fail(f'{tag} BAND_TRAIN=0: band launches {res}')
    want = passes['default']
    floor = 1e-4 * max(float(g.abs().max()) for g in want.values())
    for name in ('band_train_off', 'band_train_off_snapped'):
        got = passes[name]
        if set(got) != set(want):
            fail(f'{tag} {name}: other parameters have gradients')
        res[name]['loss_rel'] = abs(res[name]['loss'] - d['loss']) \
            / abs(d['loss'])
        res[name]['grad_worst_over_scale'] = sorted(
            ((float((got[n] - g).abs().max())
              / max(float(g.abs().max()), floor), n)
             for n, g in want.items()), reverse=True)[:3]
        res[name]['grad_worst_over_norm'] = _grad_norm_worst(got, want)
        res[name]['pre_activation_sign_flips'] = sign_flips(
            pre['default'], pre[name])
    print(f'[{tag}] VirConv-T training step, VIRCONV_BAND_TRAIN=0 vs the '
          f'default: {json.dumps(res)}', flush=True)
    snapped = res['band_train_off_snapped']
    if not (off['loss_rel'] <= 1e-4 and snapped['loss_rel'] <= 1e-4
            and snapped['grad_worst_over_scale'][0][0] <= 1e-3):
        fail(f'{tag} BAND_TRAIN=0 step differs: loss rel '
             f'{off["loss_rel"]}, snapped gradients '
             f'{snapped["grad_worst_over_scale"]} x scale')
    del trainer, model, passes, pre
    torch.cuda.empty_cache()
    return res


def routing_phase(frames, card):
    """Phase 15: the JAX package's routing switches at full width, f32
    operands, TF32 off: VirConv-T on phase 3's request under the default
    route and each of T_ROUTES, VirConv-L under L_ROUTES (``routes_for``);
    the dense LiDAR tail (``dense_tail_phase``); a T training step under
    ``VIRCONV_BAND_TRAIN=0`` (``band_train_off_step``), on ``card``
    (nvidia-smi's name and power limit). Returns (kernel lines by kernel,
    their launches, the numbers)."""
    import torch
    from virconv_tpu_torch.config import virconv_l_config
    from virconv_tpu_torch.serve import Detector
    from virconv_tpu_torch.utils.bench_inputs import (FRAMES, synth_frames_l,
                                                      train_batch)
    print(f'[phase 15] {card}: the routing switches, f32 operands, TF32 '
          'off', flush=True)
    det = Detector(device='cuda', seed=0, bf16=False)
    t_routes, nmap_lines, tiled_lines, counts = routes_for(
        det, frames, 'VirConv-T', T_ROUTES)
    dense_tail = dense_tail_phase(det, frames)
    del det
    det_l = Detector(cfg=virconv_l_config(), device='cuda', seed=0,
                     bf16=False)
    l_routes, _, _, _ = routes_for(det_l, synth_frames_l(FRAMES),
                                   'VirConv-L', L_ROUTES)
    del det_l
    torch.cuda.empty_cache()
    step = band_train_off_step(train_batch())
    return ({'nmap_conv_fwd_eval': nmap_lines,
             'roi_pool_fwd_tiled': tiled_lines}, counts,
            {'card': card, 'virconv_t': t_routes, 'virconv_l': l_routes,
             'dense_tail': dense_tail, 'band_train_off_step': step})


# ---- phase 16: the multi-rank tools ----------------------------------------

# the ranks of both multi-rank runs, all on cuda:0 over gloo: the JAX
# tools' 8 devices
MR_RANKS = 8


def multi_rank_phase(card, device='cuda', cfg=None, ranks=MR_RANKS):
    """Phase 16, on ``card`` (nvidia-smi's name and power limit), ``ranks``
    ranks on cuda:0 over gloo: (a) ``entry.dryrun_multichip``: a finite
    loss, K1 and K4 launched on every rank, and the capacity caps that
    dropped rows on each rank beside those of one process's step on the
    same entries (the JAX mesh sizes its caps as one process does); (b)
    ``parallel.fullwidth.run_fullwidth`` (the full-width VirConv-T step
    over 8 frames, then the evaluation of 24 entries, merged) with its
    gates, and its merged prediction dicts against one process's
    evaluation of the same entries from rank 0's trained weights (the same
    detection counts per frame, boxes within 5e-3, scores within 2e-3).
    An out-of-memory error fails the phase. ``device`` and ``cfg`` (the
    full-width run's) let a CPU rehearsal run it. Returns the numbers."""
    import torch
    from virconv_tpu_torch import entry
    from virconv_tpu_torch.ops import sparse
    from virconv_tpu_torch.parallel import fullwidth as fw
    from virconv_tpu_torch.train.trainer import Trainer
    cuda = device == 'cuda'
    tag = 'phase 16'
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    loss, dry_ranks = entry.dryrun_multichip(ranks, device=device,
                                             backend='gloo')
    seconds = time.perf_counter() - t
    sparse.CAP_LOG = []
    try:
        with torch.enable_grad():
            Trainer(entry.dryrun_config(), device=device, seed=0,
                    total_steps=entry.DRYRUN_TOTAL_STEPS).step(
                        entry.dryrun_batch(ranks))
        one_caps = sparse.CAP_LOG
    finally:
        sparse.CAP_LOG = None
    steps = [r['steps'][0] for r in dry_ranks]
    dry = {'ranks': ranks, 'backend': 'gloo', 'loss': loss,
           'seconds': seconds,
           'step_ms': [s['seconds'] * 1e3 for s in steps],
           'peak_gib': [(s['peak_bytes'] or 0) / 2 ** 30 for s in steps],
           'sync_bn_calls': steps[0]['collectives']['moments']['calls'],
           'launches': [s['launches'] for s in steps],
           'dropped_rows': [entry.dropped_rows(r['caps'])
                            for r in dry_ranks],
           'one_process_dropped_rows': entry.dropped_rows(one_caps)}
    print(f'[{tag}a] card "{card}": dryrun_multichip({ranks}) over '
          f'gloo on one card, the small preset: loss {loss!r}, step ms per '
          f'rank {dry["step_ms"]} ({dry["sync_bn_calls"]} sync-BN '
          f'all-reduces, untimed), peak GiB per rank {dry["peak_gib"]}, '
          f'{seconds:.1f} s with the start of the ranks, launches '
          f'of rank 0 {dry["launches"][0]}', flush=True)
    print(f'[{tag}a] caps that dropped rows (site, capacity, rows): per '
          f'rank {dry["dropped_rows"]}; one process on the same '
          f'{ranks} entries {dry["one_process_dropped_rows"]}', flush=True)
    if not np.isfinite(loss):
        fail(f'dryrun_multichip({ranks}): loss {loss}')
    for r in dry['launches']:
        if cuda and not (r['band_conv_fwd'] and r['band_conv_dw']):
            fail(f'a rank of the dry run missed K1 or K4: {r}')

    rec, det = fw.run_fullwidth(ranks, device, 'gloo', cfg=cfg, timeout=600)
    t = time.perf_counter()
    want = fw.one_process_eval(det['cfg'], det['ranks'][0]['state_dict'],
                               det['eval_batch'], ranks, device)
    cmp = fw.compare_preds(det['pred_dicts'], want)
    results = det['ranks']

    def coll(r, kind):
        c = r['train']['collectives'][kind]
        return {'calls': c['calls'], 'bytes': c['bytes'],
                'ms': c['seconds'] * 1e3}
    report = {
        'card': card, 'record': rec, 'dryrun': dry,
        'sync_bn': [coll(r, 'moments') for r in results],
        'grad_allreduce': [coll(r, 'grads') for r in results],
        'train_launches': [r['train']['launches'] for r in results],
        'eval_s': [r['eval']['seconds'] for r in results],
        'eval_peak_gib': [(r['eval']['peak_bytes'] or 0) / 2 ** 30
                          for r in results],
        'eval_launches': [r['eval']['launches'] for r in results],
        'one_process': {**cmp, 'seconds': time.perf_counter() - t}}
    print(f'[{tag}b] card "{card}": the full-width VirConv-T run over '
          f'{ranks} ranks on one card over gloo: {json.dumps(rec)}',
          flush=True)
    print(f'[{tag}b] per rank: step s {rec["step_s"]} (collectives '
          f'synchronized and timed), peak GiB {rec["peak_gib"]}, sync-BN '
          f'{json.dumps(report["sync_bn"][0])} on rank 0 (ms per rank '
          f'{[c["ms"] for c in report["sync_bn"]]}), gradient all-reduce '
          f'ms {[c["ms"] for c in report["grad_allreduce"]]}, training '
          f'launches {report["train_launches"]}; evaluation s '
          f'{report["eval_s"]}, peak GiB {report["eval_peak_gib"]}, '
          f'launches {report["eval_launches"]}', flush=True)
    print(f'[{tag}b] merged dicts vs one process (rank 0\'s weights, a '
          f'rank\'s share per forward: this checks that every rank held '
          f'rank 0\'s weights and the merge kept rank order, not the '
          f'split): {json.dumps(report["one_process"])}', flush=True)
    if not cmp['agree']:
        fail('the merged evaluation of the ranks differs from one process')
    return report


# ---- phase 17: the RPN's rotated NMS on the kernel pair -------------------

# The plain composition's f32 operations a pair (ops/boxes.py): 503 for each
# of the two clipped-edge integrals (23 per edge and half-plane, 12 for the
# reductions over half-planes, 21 per edge after them, 3 for the edges' sum)
# and 11 for the IoU, its threshold and the masks.
NMS_PAIR_OPS = 2 * 503 + 11


class NmsCapture:
    """Records the arguments and the results (sel, sel_valid) of every
    ``box_ops.nms_bev_batched`` call (the calls still run) while
    entered."""

    def __enter__(self):
        from virconv_tpu_torch.ops import boxes
        self._boxes, self._orig = boxes, boxes.nms_bev_batched
        self.calls, self.outs = [], []

        def record(boxes_, scores, thresh, pre_max, post_max, valid=None,
                   num_iters=8):
            self.calls.append((boxes_.detach().clone(),
                               scores.detach().clone(), thresh, pre_max,
                               post_max, valid, num_iters))
            out = self._orig(boxes_, scores, thresh, pre_max, post_max,
                             valid, num_iters)
            self.outs.append(tuple(t.clone() for t in out))
            return out
        boxes.nms_bev_batched = record
        return self

    def __exit__(self, *exc):
        self._boxes.nms_bev_batched = self._orig
        return False


def check_nms_case(name, args, out, launches):
    """One ``nms_bev_batched`` call of the main path, its arguments
    ``args``, results ``out`` and the launches counted around it, against
    the plain ``nms_bev`` of each entry: the same sel and sel_valid, and
    the mask's bits (one more launch on ``args``) the plain suppression's
    on the strict lower triangle. Times: the call (events around the
    wrapper: sort, top-k, corners, both kernels), each kernel alone (from
    a CUDA graph), the plain loop; the bound at the f32 peak over the
    triangle's pairs."""
    import torch
    from virconv_tpu_torch.ops import _cuda
    from virconv_tpu_torch.ops import boxes as box_ops
    boxes, scores, thresh, pre, post, valid, iters = args
    b = boxes.shape[0]
    sel, sel_valid = out
    order, top_valid, top = box_ops.nms_top_k(boxes, scores, pre, valid)
    k = top.shape[1]
    mask, _ = box_ops._nms_mask_cuda(top, top_valid, thresh)
    kept = []
    for i in range(b):
        want = box_ops.nms_bev(boxes[i], scores[i], thresh, pre, post,
                               valid, iters)
        if not (torch.equal(sel[i], want[0])
                and torch.equal(sel_valid[i], want[1])):
            fail(f'{name}: entry {i} selects other proposals than nms_bev')
        one = slice(i, i + 1)
        if not torch.equal(box_ops.nms_mask_bits(mask[one], k),
                           box_ops.nms_sup_plain(top[one], top_valid[one],
                                                 thresh)):
            fail(f'{name}: entry {i} mask bits differ from the plain IoU')
        kept.append(int(want[1].sum()))
    geometry = (*box_ops.nms_geometry(top), top_valid.contiguous())
    lib = _cuda.load('nms')
    ptrs = [*map(_cuda.ptr, geometry), b, k, float(thresh), _cuda.ptr(mask)]
    pairs = b * k * (k - 1) // 2
    line = {'case': name, 'entries': b, 'k': k, 'post': post,
            'thresh': thresh, 'kept': kept, 'pairs': pairs,
            'bytes': nbytes(*geometry, mask, sel, sel_valid),
            'ops': pairs * NMS_PAIR_OPS, 'launches': launches,
            'ms': cuda_ms(lambda: box_ops.nms_bev_batched(*args)),
            'mask_device_ms': graph_ms(lambda: lib.nms_overlap_mask(
                *ptrs, _cuda.stream_ptr(boxes.device))),
            'select_device_ms': graph_ms(lambda: box_ops._nms_select_cuda(
                mask, top_valid, order, post, iters)),
            'plain_ms': cuda_ms(lambda: [
                box_ops.nms_bev(boxes[i], scores[i], thresh, pre, post,
                                valid, iters) for i in range(b)], 3, 1)}
    line['device_ms'] = line['mask_device_ms'] + line['select_device_ms']
    bound(line, F32_FLOPS)
    print(f'[phase 17] {name}: {json.dumps(line)}', flush=True)
    return line


def nms_phase(frames):
    """Phase 17: the RPN's NMS of one full-width VirConv-T training step
    (2 frames x ROT_NUM 3: 6 entries at k = 4000) and of one request (2
    entries at k = 2000), with the launch count set to 0 just before the
    step or request and read just after (one call, two launches each);
    each call's arguments and results held against the plain version and
    timed (``check_nms_case``). Returns the two lines."""
    import torch
    from virconv_tpu_torch.ops import boxes as box_ops
    from virconv_tpu_torch.serve import Detector
    from virconv_tpu_torch.train.trainer import Trainer
    from virconv_tpu_torch.utils.bench_inputs import train_batch

    def counted(run):
        with NmsCapture() as cap:
            box_ops.nms_launches = 0
            run()
            torch.cuda.synchronize()
            launches = box_ops.nms_launches
        if len(cap.calls) != 1 or launches != 2:
            fail(f'NMS: {len(cap.calls)} calls and {launches} launches in '
                 'a step or request, not 1 and 2')
        return cap.calls[0], cap.outs[0], launches

    with torch.enable_grad():
        trainer = Trainer(device='cuda', seed=0)
        batch = trainer.to_device(train_batch())
        step = counted(lambda: trainer.step(batch))
        del trainer, batch
    det = Detector(device='cuda', seed=0)
    request = counted(lambda: det(frames))
    del det
    torch.cuda.empty_cache()
    return {'train_step': check_nms_case('train step', *step),
            'request': check_nms_case('request', *request)}


def main():
    import torch
    if not torch.cuda.is_available():
        print('FAIL: torch.cuda.is_available() is False', flush=True)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_grad_enabled(False)
    from virconv_tpu_torch.configs.tiny import tiny_config
    from virconv_tpu_torch.ops import _cuda, native
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
    cases, taps, pools = request_kernel_calls(det, frames)
    missing = ({27, 9, 3} - taps) | ({(8, 216), (8, 64), (4, 64)} - pools)
    if missing:
        fail(f'warm-up forward never reached {sorted(missing)} '
             '(band-conv taps / pool (stride, Q))')
    totals = {k: summed(v) for k, v in cases.items()}
    print(f'[phase 2] per request, summed over its calls: '
          f'{json.dumps(totals)}', flush=True)

    # ---- phase 3: the main path --------------------------------------------
    t0 = phase_done(2, t0)
    counts, serve_run = serve_requests(
        det, frames, N_REQUESTS, 'VirConv-T',
        {k: len(cases[k]) for k in ('band_conv_fwd', 'band_conv_patch')})
    del det

    # ---- phase 4: tiny config, CUDA kernels vs CPU plain -------------------
    t0 = phase_done(3, t0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny_serve_parity(tiny_config())

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
        step_totals['gather_rows_bwd']['split'] = rows_bwd_split(
            train_cases['gather_rows_bwd'])
        per_launch(train_cases['gather_rows_fwd'], 'rows', 'phase 5',
                   'gather_rows forward')

        # ---- phase 6: the main training path --------------------------------
        t0 = phase_done(5, t0)
        train_counts, train_run = train_steps(
            trainer, batch, N_TRAIN_STEPS,
            per_step=per_step_launches(train_cases),
            nmap_convs=NMAP_TRAIN_CONVS['VirConv-T'])
        del trainer
        torch.cuda.empty_cache()
        # 6b: one step's backward twice, every gradient compared (fault C4)
        train_run['backward_twice'] = backward_twice(None, batch)
        del batch

        # ---- phase 7: tiny config training step, CUDA vs CPU ----------------
        t0 = phase_done(6, t0)
        tiny_train_parity(('cpu', 'cuda'), gate_unsnapped=False)

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
              for a, b, *_ in zip(*gather_cases.values())}
    print(f'[phase 8] per request, summed over its 24 convs (k1_ms: K1 on '
          f'the same layers with the same operand type): '
          f'{json.dumps(gather_totals)}', flush=True)
    print(f'[phase 8] misses per layer: {json.dumps(misses)}', flush=True)

    # ---- phase 9: the evaluation path (loader, model, dicts, AP) ------------
    t0 = phase_done(8, t0)
    from virconv_tpu_torch.train.checkpoint import latest_checkpoint
    from virconv_tpu_torch.utils.common import create_logger
    logger = create_logger()
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        eval_run = eval_scene(tmp, EVAL_FRAMES, FRAMES, logger)
        eval_run['tiny_cuda_vs_cpu'] = eval_tiny_parity(tmp, logger)
        t0 = phase_done(9, t0)

        # ---- phase 10: training from a KITTI tree (loader, CLI, resume) -----
        with torch.enable_grad():
            train_cli = train_cli_scene(tmp, TRAIN_FRAMES, TRAIN_N_TRAIN,
                                        FRAMES)
            train_cli['tiny_cuda_vs_cpu'] = train_loader_tiny_parity(tmp)
        t0 = phase_done(10, t0)

        # ---- phase 11: VirConv-L, and VirConv-S from phase 10's checkpoint --
        # (C4's gate for VirConv-T first: two seeded trainers, phase 6's
        # batch, the same bits after every step; VirConv-L's in 11c)
        with torch.enable_grad():
            t_steps_twice = steps_twice(None, train_batch(), N_TRAIN_STEPS,
                                        'phase 11', 'VirConv-T')
        l_cases, virconv_l = virconv_l_phase(tmp, logger)
        virconv_l['train']['steps_twice_virconv_t'] = t_steps_twice
        with torch.enable_grad():
            virconv_s = semi_train_cli(
                tmp, latest_checkpoint(tmp / 'train_run' / 'ckpt'), FRAMES)
        t0 = phase_done(11, t0)

        # ---- phase 12: PENet virtual points, then VirConv-T on them ---------
        vp_cases, virtual_points = virtual_points_phase(tmp, logger)
        t0 = phase_done(12, t0)

        # ---- phase 13: the JAX package's precision switches -----------------
        # (TF32 still off, as set for phase 4)
        p_cases, p_counts, precision = precision_phase(frames)
        t0 = phase_done(13, t0)

        # ---- phase 14: data parallel, 2 ranks on this card over gloo --------
        data_parallel = {'step': dp_step_phase(card)}
        data_parallel['eval'], data_parallel['train_cli'] = dp_cli_phase(
            tmp, logger, card)
    t0 = phase_done(14, t0)

    # ---- phase 15: the JAX package's routing switches ----------------------
    # (TF32 still off, as set for phase 4)
    r_cases, r_counts, routing = routing_phase(frames, card)
    t0 = phase_done(15, t0)

    # ---- phase 16: the multi-rank tools, every rank on this card ----------
    multi_rank = multi_rank_phase(card)
    t0 = phase_done(16, t0)

    # ---- phase 17: the RPN's rotated NMS on the kernel pair ---------------
    nms = nms_phase(frames)
    phase_done(17, t0)

    # ---- result -------------------------------------------------------------
    src = 'virconv_tpu_torch/csrc/band_conv.cu'
    meta = {'band_conv_fwd': (src, 'virconv_tpu/ops/pallas/band_conv.py:139'),
            'roi_pool_fwd': ('virconv_tpu_torch/csrc/roi_pool.cu',
                             'virconv_tpu/ops/pallas/roi_pool.py:241+268'),
            'band_conv_dw': (src, 'virconv_tpu/ops/pallas/band_conv.py:188'),
            'gather_conv_fwd': ('virconv_tpu_torch/csrc/gather_conv.cu',
                                'virconv_tpu/ops/pallas/gather_conv.py:42'),
            'onehot_conv_fwd': ('virconv_tpu_torch/csrc/gather_conv.cu',
                                'virconv_tpu/ops/pallas/onehot_conv.py:40'),
            # the band conv's gather patch, in K1's call, and the conv of
            # the neighbor-map branch: XLA's gather + matmul there
            'band_conv_patch': (src, 'virconv_tpu/ops/sparse.py:238'),
            'nmap_conv_fwd': ('virconv_tpu_torch/csrc/gather_conv.cu',
                              'virconv_tpu/ops/sparse.py:238'),
            # not Pallas kernels: the pool gathers' custom_vjp and the
            # XLA-fused CSPN loop there
            'gather_rows': ('virconv_tpu_torch/csrc/gather_rows.cu',
                            'virconv_tpu/models/roi_heads/voxel_pool.py:50'),
            'cspn': ('virconv_tpu_torch/csrc/cspn.cu',
                     'virconv_tpu/models/depth_completion/penet.py:272')}
    launches = {**counts, 'band_conv_dw': train_counts['band_conv_dw'],
                **gather_counts, 'gather_rows': train_counts['gather_rows'],
                'cspn': virtual_points['cspn_launches']}
    totals['band_conv_dw'] = step_totals['band_conv_dw']
    totals.update(gather_totals)
    totals['band_conv_patch'] = patch_totals(cases['band_conv_patch'])
    # gather_rows per training step (forward and backward calls), cspn per
    # frame (its 12 iterations)
    rows_lines = (train_cases['gather_rows_fwd']
                  + train_cases['gather_rows_bwd'])
    totals['gather_rows'] = {
        **summed(rows_lines, 'step'),
        'forward': step_totals['gather_rows_fwd'],
        'backward': step_totals['gather_rows_bwd']}
    totals['cspn'] = summed(vp_cases, 'frame')
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
    by_name['band_conv_patch']['train'] = {
        'launches': train_counts['band_conv_patch'],
        **patch_totals(train_cases['band_conv_patch_train'], 'step')}
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
    # phase 11: VirConv-L's K1 and K2+K3 per request, K1 and K4 per step
    l_totals = {k: summed(v) for k, v in l_cases.items()
                if k in ('band_conv_fwd', 'roi_pool_fwd', 'band_conv_patch')}
    l_steps = {k: summed(v, 'step') for k, v in l_cases.items()
               if k not in l_totals}
    l_serve, l_train = virconv_l['serve'], virconv_l['train']
    for k in kernels[:2]:
        k['virconv_l'] = {'launches': l_serve['launches'][k['name']],
                          **l_totals[k['name']],
                          'launches_eval':
                          virconv_l['eval']['launches'][k['name']]}
    kernels[0]['virconv_l']['train'] = {
        'launches': l_train['launches']['band_conv_fwd'],
        **summed(l_cases['band_conv_fwd_train']
                 + l_cases['band_conv_fwd_train_dgrad'], 'step'),
        'forward': l_steps['band_conv_fwd_train'],
        'input_grad': l_steps['band_conv_fwd_train_dgrad']}
    by_name['band_conv_dw']['virconv_l'] = {
        'launches': l_train['launches']['band_conv_dw'],
        **l_steps['band_conv_dw']}
    by_name['band_conv_patch']['virconv_l'] = {
        'launches': l_serve['launches']['band_conv_patch'],
        **patch_totals(l_cases['band_conv_patch']),
        'contexts_past_the_jax_patch_cap':
        l_serve['contexts_past_the_jax_patch_cap'],
        'train': {'launches': l_train['launches']['band_conv_patch'],
                  **patch_totals(l_cases['band_conv_patch_train'], 'step')}}
    by_name['gather_rows']['backward_split'] = step_totals[
        'gather_rows_bwd']['split']
    by_name['gather_rows']['virconv_l'] = {
        'launches': l_train['launches']['gather_rows'],
        **summed(l_cases['gather_rows_fwd'] + l_cases['gather_rows_bwd'],
                 'step'),
        'forward': l_steps['gather_rows_fwd'],
        'backward': l_steps['gather_rows_bwd']}
    # phase 13: K1 with bf16 features (T and L per request), K1 and K4 with
    # bf16 operands per training step, K2+K3 with f32 operands per request
    kernels[0]['bf16_feats'] = {
        'launches': p_counts['bf16_feats']['band_conv_fwd'],
        **summed(p_cases['bf16_feats']),
        'bit_equal_share': min(c['bit_equal_share']
                               for c in p_cases['bf16_feats']),
        'virconv_l': {
            'launches': p_counts['bf16_feats_virconv_l']['band_conv_fwd'],
            **summed(p_cases['bf16_feats_virconv_l'])}}
    kernels[0]['train_bf16'] = {
        'launches': p_counts['train_bf16']['band_conv_fwd'],
        **summed(p_cases['band_conv_fwd_train_bf16']
                 + p_cases['band_conv_fwd_train_dgrad_bf16'], 'step')}
    by_name['band_conv_dw']['train_bf16'] = {
        'launches': p_counts['train_bf16']['band_conv_dw'],
        **summed(p_cases['band_conv_dw_bf16'], 'step')}
    by_name['roi_pool_fwd']['pool_f32'] = {'launches': p_counts['pool_f32'],
                              **summed(p_cases['pool_f32'])}
    # phase 15: nmap_conv on every eval conv (VIRCONV_BAND=0) and K2+K3 in
    # its quadrant-tiled mode (VIRCONV_POOL_TILE=1), per T request
    for name, (s, rep) in (
            ('nmap_conv_fwd_eval', meta['nmap_conv_fwd']),
            ('roi_pool_fwd_tiled', meta['roi_pool_fwd'])):
        kernels.append({'name': name, 'route': 'cuda', 'source': s,
                        'replaces': rep, 'launches': r_counts[
                            name.replace('_eval', '')],
                        **summed(r_cases[name])})
    # the training neighbor-map conv per T step (phase 5's calls, phase 6's
    # launches) and per L step (11a, 11c): nmap_conv's forward and
    # input-gradient calls (the JAX package's gathered_conv_train), and
    # nmap_conv_dw's weight gradients (its _gct_bwd loop) with the band
    # convs' gather-patch terms (_band_train_bwd's loop)
    for name, s_, rep, parts in (
            ('nmap_conv_fwd_train', meta['nmap_conv_fwd'][0],
             'virconv_tpu/ops/sparse.py:284',
             (('forward', 'nmap_conv_fwd_train'),
              ('input_grad', 'nmap_conv_fwd_train_dgrad'))),
            ('nmap_conv_dw', src, 'virconv_tpu/ops/sparse.py:333+905',
             (('conv', 'nmap_conv_dw'), ('patch', 'nmap_conv_dw_patch')))):
        launch_key = name.replace('_train', '')
        kernels.append({
            'name': name, 'route': 'cuda', 'source': s_, 'replaces': rep,
            'launches': train_counts[launch_key],
            **summed([c for _, k in parts for c in train_cases[k]], 'step'),
            **{part: step_totals[k] for part, k in parts},
            'virconv_l': {
                'launches': l_train['launches'][launch_key],
                **summed([c for _, k in parts for c in l_cases[k]], 'step'),
                **{part: l_steps[k] for part, k in parts}}})
    # phase 17: the kernel pair of the RPN's NMS (an XLA composition there);
    # launches: phase 17's step and request, and over phase 6's steps and
    # phase 3's requests
    kernels.append({'name': 'nms', 'route': 'cuda',
                    'source': 'virconv_tpu_torch/csrc/nms.cu',
                    'replaces': 'virconv_tpu/ops/boxes.py:272',
                    **nms['train_step'],
                    'launches_phase6': train_counts['nms'],
                    'request': {**nms['request'],
                                'launches_phase3': counts['nms']}})
    print(json.dumps({'kernels': kernels, 'serve': serve_run,
                      'train_step': train_run,
                      'eval': eval_run, 'train_cli': train_cli,
                      'virconv_l': virconv_l, 'virconv_s': virconv_s,
                      'virtual_points': virtual_points, 'cases': cases,
                      'cases_virconv_l': l_cases,
                      'cases_cspn': vp_cases, 'precision': precision,
                      'cases_precision': p_cases,
                      'data_parallel': data_parallel, 'routing': routing,
                      'cases_routing': r_cases, 'multi_rank': multi_rank}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
