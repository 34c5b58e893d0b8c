"""Summarize saved ``chip_smoke.py`` outputs, one column per run.

    python3 chip_smoke.py > run1.log
    python3 -m virconv_tpu_torch.smoke_report run1.log [run2.log ...]

Reads each log's per-kernel JSON line and card line and prints: each
kernel's time summed over a request (serving, phase 8; K6 with bf16 and
f32 operands) or a training step (phase 5) beside its bound, and K5's and
K6's launches by mode; the widest and the first call of K1, K4, K5 and
K6; the training step times; the evaluation's seconds per frame (phase
9); the training CLI's ms per step, peak memory, loader seconds per frame
and share of the loop spent waiting on the loader (phase 10a); VirConv-L's
kernel sums, ms per request and per step, pool routes and evaluation, and
VirConv-S's CLI steps (phase 11), the gather patch's sums (and those of
the composition it replaced) and VirConv-L's contexts past the JAX
package's patch cap on both routes; the kernel launches of one request;
the pool gathers' (``gather_rows``) sums per training step beside
``index_add_`` and its backward's parts, its forward calls' and the CSPN
launches' times per launch (and device times alone, where the log has
them) beside their bounds,
phase 6b's gradient comparison and phase 11's two seeded trainers (fault
C4); phase 12's CSPN kernel per frame, generation seconds per frame by
stage, points per frame and the VirConv-T evaluation of the generated
points; phase 13's precision modes (K1 with bf16 features per T and L
request, K1 and K4 with bf16 operands per training step, K2+K3 at f32
operands per request, the requests, steps and the ODIoU step); phase
14's data-parallel rehearsal (2 ranks on one card over gloo: step ms per
rank, the gradient and sync-BN all-reduces per step, peak memory, the
comparison with one process, the distributed evaluation and training
CLI); phase 16's multi-rank tools (the full-width run's step seconds,
sync-BN and gradient all-reduce ms, peak memory and evaluation seconds
per rank, its merged dicts against one process, the dry run's step per
rank); and phase 8's sums by layer shape (K, C -> C'). A row a log lacks
(an older chip_smoke) shows as '-'. Times are the card's, as chip_smoke
measured them; nothing here runs on a card.
"""

from __future__ import annotations

import json
import sys


def _load(path):
    card, data = None, None
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if line.startswith('{"kernels"'):
            data = json.loads(line)
            card = lines[i + 1] if i + 1 < len(lines) else None
    if data is None:
        raise SystemExit(f'{path}: no chip_smoke result line')
    return card, data


def _width(c):
    return c.get('rows', c.get('rows_out', 0)) * c['c_in'] * c['c_out']


def _shape(c):
    small = c['c_in'] <= 16 and c['c_out'] <= 16
    io = '8-16 -> 8-16' if small else f'{c["c_in"]} -> {c["c_out"]}'
    return f'{c["taps"]}, {io}'


def rows_of(data):
    """(label, value) pairs of one run, in print order."""
    cases, out = data['cases'], []

    def total(label, k, launches):
        lib = k.get('library_ms')
        out.append((f'{label}: ms, launches, bound (by), plain ms'
                    + (', library ms' if lib is not None else ''),
                    f'{k["ms"]:.3f} x{launches} {k["bound_ms"]:.4f} '
                    f'({k["bound_by"]}) {k["plain_ms"]:.1f}'
                    + (f' {lib:.3f}' if lib is not None else '')))
        if 'device_ms' in k:                 # cspn, gather_rows forward
            out.append((f'{label}: device ms', f'{k["device_ms"]:.4f}'))

    def launch_range(label, calls, key):
        """ms per launch (and device ms) and bound, by ``key``."""
        groups = {}
        for c in calls:
            groups.setdefault(c[key], []).append(c)
        for g, cs in groups.items():
            def span(f):
                v = [c[f] for c in cs if f in c]
                return f'{min(v):.4f}-{max(v):.4f}' if v else '-'
            out.append((f'{label} {key} {g}: ms per launch, device ms, '
                        'bound', f'{span("ms")} {span("device_ms")} '
                        f'{span("bound_ms")} x{len(cs)}'))
    units = {'band_conv_dw': 'step', 'gather_rows': 'step', 'cspn': 'frame',
             'nmap_conv_fwd_train': 'step', 'nmap_conv_dw': 'step',
             'nms': 'step'}
    for k in data['kernels']:
        unit = units.get(k['name'], 'request')
        total(f'{k["name"]} per {unit}', k, k['launches'])
        # gather_rows; the training neighbor-map conv's products
        for part in ('forward', 'backward', 'input_grad', 'conv', 'patch'):
            if part in k:
                total(f'{k["name"]} {part} per {unit}', k[part],
                      k[part][f'launches_per_{unit}'])
        if 'prev_ms' in k:                   # nmap_conv's previous body
            out.append((f'{k["name"]}: ms, previous body ms',
                        f'{k["ms"]:.3f} {k["prev_ms"]:.3f}'))
        if 'train' in k:
            parts = [p for p in ('forward', 'input_grad') if p in k['train']]
            for part in parts:
                total(f'{k["name"]} train {part} per step', k['train'][part],
                      k['train']['launches'])
            if not parts:
                total(f'{k["name"]} train per step', k['train'],
                      k['train']['launches'])
        if 'f32' in k:
            total(f'{k["name"]} f32 per request', k['f32'],
                  k['f32']['launches'])
        if 'request' in k:                   # nms: a step's call above
            total(f'{k["name"]} per request', k['request'],
                  k['request']['launches'])
        if 'launches_by_mode' in k:
            out.append((f'{k["name"]} launches by mode',
                        json.dumps(k['launches_by_mode'], sort_keys=True)))
        for where, pk in (('', k), (' train', k.get('train', {})),
                          (' VirConv-L', k.get('virconv_l', {})),
                          (' VirConv-L train',
                           k.get('virconv_l', {}).get('train', {}))):
            if 'old_ms' in pk:               # the joined gather patch
                out.append((f'{k["name"]}{where}: ms, before joining K1 ms',
                            f'{pk["ms"]:.3f} {pk["old_ms"]:.3f}'))
        split = k.get('backward_split')      # gather_rows' backward
        if split is not None:
            out.append(('gather_rows backward per step: CSR, sums, hot-row '
                        'tail, the previous CSR (torch.sort) ms',
                        ' '.join(f'{split[p]:.3f}' for p in (
                            'csr_ms', 'sum_ms', 'hot_row_tail_ms',
                            'csr_sort_ms'))))
        for key, label, unit_ in (             # phase 13 (absent before)
                ('bf16_feats', 'bf16 features', 'request'),
                ('train_bf16', 'bf16 operands', 'step'),
                ('pool_f32', 'f32 operands', 'request')):
            pk = k.get(key)
            if pk is not None:
                total(f'{k["name"]} {label} per {unit_}', pk, pk['launches'])
                if 'virconv_l' in pk:
                    total(f'VirConv-L {k["name"]} {label} per {unit_}',
                          pk['virconv_l'], pk['virconv_l']['launches'])
        lk = k.get('virconv_l')              # phase 11 (absent before)
        if lk is not None:
            total(f'VirConv-L {k["name"]} per {unit}', lk, lk['launches'])
            lcases = data.get('cases_virconv_l', {})
            for part, key in (('forward', 'gather_rows_fwd'),
                              ('backward', 'gather_rows_bwd')):
                if k['name'] == 'gather_rows' and lcases.get(key):
                    # from the calls' lines: older logs lack the split
                    calls = lcases[key]
                    out.append((f'VirConv-L gather_rows {part} per step: '
                                'ms, launches, device ms',
                                f'{sum(c["ms"] for c in calls):.3f} '
                                f'x{len(calls)} ' + (
                                    f'{sum(c["device_ms"] for c in calls):.4f}'
                                    if all('device_ms' in c for c in calls)
                                    else '-')))
            for part in ('forward', 'input_grad'):
                if part in lk.get('train', {}):
                    total(f'VirConv-L {k["name"]} train {part} per step',
                          lk['train'][part], lk['train']['launches'])
            for c in lk.get('contexts_past_the_jax_patch_cap', []):
                out.append((f'VirConv-L {c["case"]} ({c["patch_rows"]} patch '
                            f'rows, {c["convs"]} convs): ms, JAX branch ms',
                            f'{c["ms"]:.3f} {c["jax_branch_ms"]:.3f}'))
    for name in ('band_conv_fwd', 'band_conv_fwd_train',
                 'band_conv_fwd_train_dgrad', 'band_conv_dw',
                 'onehot_conv_fwd', 'onehot_conv_fwd_f32',
                 'gather_conv_fwd'):
        calls = cases.get(name, [])
        for which, c in (('widest', max(calls, key=_width, default=None)),
                         ('first', calls[0] if calls else None)):
            if c is not None:
                out.append((f'{name} {which} ({_shape(c)}): ms, bound, plain',
                            f'{c["ms"]:.4f} {c["bound_ms"]:.4f} '
                            f'{c["plain_ms"]:.2f}'))
    launch_range('gather_rows forward', cases.get('gather_rows_fwd', []),
                 'rows')
    launch_range('cspn', data.get('cases_cspn', []), 'stage')
    if 'serve' in data:                      # phase 3's traced request
        out.append(('kernel launches per request',
                    str(data['serve']['kernel_launches_per_request'])))
    out.append(('training ms per step', ' '.join(
        f'{t:.1f}' for t in data['train_step']['ms_per_step'])))
    ev = data.get('eval')                    # phase 9 (absent in older logs)
    if ev is not None:
        out.append(('eval: sec_per_example, loader s/frame, tail s/frame',
                    f'{ev["sec_per_example"]:.4f} '
                    f'{ev["loader_sec_per_frame"]:.4f} '
                    f'{ev["seconds"]["post"] / ev["frames"]:.4f}'))
    tc = data.get('train_cli')               # phase 10 (absent before)
    if tc is not None:
        out.append(('train_gpu: ms/step after the first, peak GiB, loader '
                    's/frame, wait share',
                    f'{tc["ms_per_step_after_first"]:.1f} '
                    f'{tc["peak_memory_gib"]:.2f} '
                    f'{tc["loader_sec_per_frame"]:.4f} '
                    f'{tc["wait_share"]:.3f}'))
        out.append(('train_gpu ms per step', ' '.join(
            f'{t:.1f}' for t in tc['ms_per_step'])))
    vl = data.get('virconv_l')               # phase 11 (absent before)
    if vl is not None:
        sv, tr = vl['serve'], vl['train']
        out.append(('VirConv-L ms per request', ' '.join(
            f'{t:.1f}' for t in sv['ms_per_request'])))
        out.append(('VirConv-L pools per request by route',
                    json.dumps(sv['pool_routes_per_request'])))
        out.append(('VirConv-L ms per step, peak GiB', ' '.join(
            f'{t:.1f}' for t in tr['ms_per_step'])
            + f' {tr["peak_memory_gib"]:.2f}'))
        if 'first_step_twice' in tr:         # before the C4 gate
            out.append(('VirConv-L first seeded step twice: losses',
                        ' '.join(repr(x) for x in
                                 tr['first_step_twice']['losses'])))
        for model, key in (('VirConv-T', 'steps_twice_virconv_t'),
                           ('VirConv-L', 'steps_twice')):
            if key in tr:
                out.append((f'{model} two seeded trainers: losses (run 1)',
                            ' '.join(f'{x:.6f}' for x in
                                     tr[key]['losses'][0])))
                out.append((f'{model} two seeded trainers: steps differing',
                            str(sum(bool(d['terms'] or d['tensors'])
                                    for d in tr[key]['differing']))))
        out.append(('VirConv-L eval: sec_per_example, loader s/frame',
                    f'{vl["eval"]["sec_per_example"]:.4f} '
                    f'{vl["eval"]["loader_sec_per_frame"]:.4f}'))
    bt = data['train_step'].get('backward_twice')   # phase 6b
    if bt is not None:
        out.append(('backward twice: modules whose gradients differ',
                    str(len(bt['modules_differing']))))
    vp = data.get('virtual_points')          # phase 12 (absent before)
    if vp is not None:
        out.append(('virtual points: s/frame ' + ', '.join(
            vp['seconds_per_frame']), ' '.join(
            f'{v:.4f}' for v in vp['seconds_per_frame'].values())))
        if 'png_read_s_per_image' in vp:
            out.append(('virtual points: PNG read s per image',
                        f'{vp["png_read_s_per_image"]:.4f}'))
        out.append(('virtual points: CSPN launches per frame, points per '
                    'frame', f'{vp["cspn_launches_per_frame"]:g} '
                    + ' '.join(str(n) for n in vp['points_per_frame'])))
        out.append(('virtual points: VirConv-T eval sec_per_example',
                    f'{vp["eval"]["sec_per_example"]:.4f}'))
        out.append(('PENetC2 64 x 96 CUDA vs CPU max err',
                    f'{vp["small_cuda_vs_cpu"]["max_abs_err"]:.3g}'))
    pr = data.get('precision')               # phase 13 (absent before)
    if pr is not None:
        for key, model in (('bf16_feats', 'VirConv-T'),
                           ('bf16_feats_virconv_l', 'VirConv-L')):
            out.append((f'{model} ms per request, bf16 features', ' '.join(
                f'{t:.1f}' for t in pr[key]['ms_per_request'])))
            vs = pr[key]['vs_f32_features']
            if 'rois_matched' in vs:         # absent before the ROI match
                out.append((f'{model} vs f32 features: ROIs matched, box / '
                            'logit max diff over them',
                            f'{vs["rois_matched"]}/{vs["rois_ref"]} '
                            f'{vs["matched_box_preds_max_abs_diff"]:.4g} / '
                            f'{vs["matched_cls_preds_max_abs_diff"]:.4g}'))
        out.append(('training ms per step, bf16 band convs', ' '.join(
            f'{t:.1f}' for t in pr['train_bf16']['ms_per_step'])))
        out.append(('OD_LOSS step: ms, rpn_loss_od',
                    f'{pr["od_loss"]["ms"]:.1f} '
                    f'{pr["od_loss"]["terms"]["rpn_loss_od"]:.4f}'))
    dp = data.get('data_parallel')           # phase 14 (absent before)
    if dp is not None:
        st = dp['step']
        out.append(('data parallel (2 ranks, one card, gloo): warm ms per '
                    'step per rank, one process', ' '.join(
                        f'{t:.1f}' for t in st['rank_step_ms'])
                    + f' {st["one_process_step_ms"]:.1f}'))
        for key, label in (('grad_allreduce', 'gradient all-reduce'),
                           ('sync_bn', 'sync-BN all-reduces')):
            c = st[key]
            out.append((f'data parallel {label} per step: calls, MB, ms',
                        f'{c["calls"]} {c["bytes"] / 1e6:.3f} '
                        f'{c["ms"]:.1f}'))
        out.append(('data parallel peak GiB per rank, one process',
                    ' '.join(f'{g:.2f}' for g in st['rank_peak_gib'])
                    + f' {st["one_process_peak_gib"]:.2f}'))
        eq = st['equality']
        out.append(('data parallel vs one process: loss rel, worst grad '
                    '(x scale, of norm), ranks / repeat bit-equal',
                    f'{eq["loss_rel_err"]:.3g} {eq["worst_grad"][0]:.3g} '
                    f'{eq["worst_grad_norm_rel"][0]:.3g} '
                    f'{eq["ranks_bit_equal"]} / {eq["repeat_bit_equal"]}'))
        out.append(('data parallel eval (2 ranks): s, max score diff',
                    f'{dp["eval"]["seconds"]:.1f} '
                    f'{dp["eval"]["max_score_diff"]:.3g}'))
        out.append(('data parallel train_gpu (2 ranks): ms per step, rank 0',
                    ' '.join(f'{t:.1f}' for t in
                             dp['train_cli']['ms_per_step'][0])))
    mr = data.get('multi_rank')              # phase 16 (absent before)
    if mr is not None:
        rec, dry = mr['record'], mr['dryrun']
        tag = f'multi-rank ({rec["devices"]} ranks, one card, gloo)'
        for label, vals, fmt in (
                ('full-width step s per rank', rec['step_s'], '.2f'),
                ('sync-BN ms per rank', [c['ms'] for c in mr['sync_bn']],
                 '.0f'),
                ('gradient all-reduce ms per rank',
                 [c['ms'] for c in mr['grad_allreduce']], '.1f'),
                ('peak GiB per rank', rec['peak_gib'], '.3f'),
                ('evaluation s per rank', mr['eval_s'], '.3f'),
                (f'dry run ({dry["ranks"]} ranks) ms per step per rank',
                 dry['step_ms'], '.0f')):
            out.append((f'{tag} {label}', ' '.join(
                format(v, fmt) for v in vals)))
        one = mr['one_process']
        out.append((f'{tag} loss, merged vs one process: box, score diff',
                    f'{rec["loss"]:.4f} {one["max_box_diff"]:.3g} '
                    f'{one["max_score_diff"]:.3g}'))
    vs = data.get('virconv_s')
    if vs is not None:
        out.append(('VirConv-S train_gpu ms per step', ' '.join(
            f'{t:.1f}' for t in vs['ms_per_step'])))
    shapes = {}
    f32 = cases.get('onehot_conv_fwd_f32')   # absent before K6 f32 timing
    for i, (c5, c6) in enumerate(zip(cases['gather_conv_fwd'],
                                     cases['onehot_conv_fwd'])):
        s = shapes.setdefault(_shape(c5), [0, 0.0, 0.0, 0.0, 0.0, 0.0])
        s[0] += 1
        s[1] += c5['ms']
        s[2] += c5['k1_ms']
        s[3] += f32[i]['ms'] if f32 else float('nan')
        s[4] += c6['ms']
        s[5] += c6['k1_ms']
    for shape, (n, *ms) in shapes.items():
        out.append((f'phase 8 [{shape}] x{n}: K5 / K1 f32 / K6 f32 / K6 / '
                    'K1 bf16', ' / '.join(f'{t:.3f}' for t in ms)))
    return out


def main(paths):
    runs = [_load(p) for p in paths]
    for p, (card, _) in zip(paths, runs):
        print(f'# {p}: {card}')
    table = [dict(rows_of(d)) for _, d in runs]
    labels = list(dict.fromkeys(label for t in table for label in t))
    for label in labels:
        print(f'{label:72s} ' + ' | '.join(t.get(label, '-') for t in table))


if __name__ == '__main__':
    main(sys.argv[1:] or sys.exit(__doc__))
