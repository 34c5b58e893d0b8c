"""Summarize saved ``chip_smoke.py`` outputs, one column per run.

    python3 chip_smoke.py > run1.log
    python3 -m virconv_tpu_torch.smoke_report run1.log [run2.log ...]

Reads each log's per-kernel JSON line and card line and prints: each
kernel's time summed over a request (serving, phase 8; K6 with bf16 and
f32 operands) or a training step (phase 5) beside its bound, and K5's and
K6's launches by mode; the widest and the first call of K1, K4, K5 and
K6; the training step times; and phase 8's sums by layer shape (K, C ->
C'). A row a log lacks (an older chip_smoke) shows as '-'. Times are the card's, as chip_smoke measured them; nothing here runs
on a card.
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
        out.append((f'{label}: ms, launches, bound (by), plain ms',
                    f'{k["ms"]:.3f} x{launches} {k["bound_ms"]:.4f} '
                    f'({k["bound_by"]}) {k["plain_ms"]:.1f}'))
    for k in data['kernels']:
        unit = 'step' if k['name'] == 'band_conv_dw' else 'request'
        total(f'{k["name"]} per {unit}', k, k['launches'])
        if 'train' in k:
            for part in ('forward', 'input_grad'):
                total(f'{k["name"]} train {part} per step', k['train'][part],
                      k['train']['launches'])
        if 'f32' in k:
            total(f'{k["name"]} f32 per request', k['f32'],
                  k['f32']['launches'])
        if 'launches_by_mode' in k:
            out.append((f'{k["name"]} launches by mode',
                        json.dumps(k['launches_by_mode'], sort_keys=True)))
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
    out.append(('training ms per step', ' '.join(
        f'{t:.1f}' for t in data['train_step']['ms_per_step'])))
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
