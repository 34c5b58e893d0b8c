"""Operations and bytes of the work the inputs need, as the reference
finds it (``refnet.tally``), and the shares of the chip's peaks that the
per-layer metrics report.

A sparse conv does 2 * pairs * C_in * C_out operations (pairs: the
(output row, tap) pairs whose input exists) and moves its rows once: 4
bytes per element of the input rows it reads and the output rows it
writes, plus its f32 weights. Training runs each conv three times (the
forward, the input gradient and the weight gradient) at the same pairs.
A ROI pool group does 8 operations per (query, voxel) pair and channel
(the 3-wide position product, the add, the ReLU and the max) and reads
its voxel rows once. A training row gather moves its rows once each way.
Dense convs and linears count 2 * MACs from their shapes.
"""

from __future__ import annotations

import re

import torch

from . import peaks

TRAIN_PASSES = 3     # forward, input gradient, weight gradient


def conv_ops_bytes(c):
    ops = 2.0 * c['pairs'] * c['c_in'] * c['c_out']
    nbytes = 4.0 * (c['n_in'] * c['c_in'] + c['n_out'] * c['c_out']
                    + c['taps'] * c['c_in'] * c['c_out'])
    return ops, nbytes


def band_route(c, train):
    """Whether the program runs conv ``c`` on the band kernels (K1, K4):
    every eval conv, and training's 3D submanifold convs; the other
    training convs run on the neighbor-map kernels."""
    return (not train) or (c['subm'] and c['taps'] == 27)


def sparse_work(s, family):
    """(ops, bytes) per item of the convs of ``family`` ('band' or
    'nmap')."""
    train = s['mode'] == 'train'
    passes = TRAIN_PASSES if train else 1
    ops = nbytes = 0.0
    for item in s['work']:
        for c in item['convs']:
            if band_route(c, train) == (family == 'band'):
                o, b = conv_ops_bytes(c)
                ops += passes * o
                nbytes += passes * b
    n = len(s['work'])
    return ops / n, nbytes / n


def pool_ops_bytes(p):
    ops = 8.0 * p['pairs'] * p['mid']
    nbytes = 4.0 * (p['n_src'] * p['mid'] + p['queries'] * (3 + p['mid']))
    return ops, nbytes


def pool_calls(s):
    """(groups, branch) of every ROI grid pool call of the profiled items:
    the reference's tally of the call's groups, and the branch the
    program's call took ('kernel' or 'probe'; None where the program's
    calls were not marked, as in training)."""
    out = []
    for item, branches in zip(s['work'], s.get('pool_branch') or
                              [None] * len(s['work'])):
        calls = item['pool_calls']
        if branches is not None and len(branches) != len(calls):
            raise ValueError(f'{len(branches)} program pool calls against '
                             f'{len(calls)} of the reference')
        out += list(zip(calls, branches or [None] * len(calls)))
    return out


def gather_bytes(g):
    rows = min(g['n'], g['m'])
    return 4.0 * g['c'] * (rows + g['m']) + 9.0 * g['m']


def dense_counter(model):
    """Forward hooks on every Conv2d, ConvTranspose2d and Linear of
    ``model`` that add 2 * MACs to the returned dict's 'conv' and
    'linear' while ``counter['on']``; ``counter['handles']`` removes
    them."""
    counter = {'on': False, 'conv': 0.0, 'linear': 0.0, 'handles': []}

    def conv(m, inputs, out):
        if counter['on']:
            k = m.kernel_size[0] * m.kernel_size[1]
            if isinstance(m, torch.nn.ConvTranspose2d):
                macs = inputs[0].numel() * m.out_channels * k / m.groups
            else:
                macs = out.numel() * m.in_channels * k / m.groups
            counter['conv'] += 2.0 * macs

    def linear(m, inputs, out):
        if counter['on']:
            counter['linear'] += 2.0 * inputs[0].numel() * m.out_features

    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            counter['handles'].append(mod.register_forward_hook(conv))
        elif isinstance(mod, torch.nn.Linear):
            counter['handles'].append(mod.register_forward_hook(linear))
    return counter


def kernel_seconds(s, names, shared=(), src_of=None):
    """Device seconds per item of the kernels whose name holds one of
    ``names`` as a word; a kernel of ``shared`` counts when the last
    source kernel before it (``src_of``: name -> family) belongs to this
    family (``src_of`` maps a source kernel name to True for this
    family, False for the other)."""
    pat = re.compile(r'\b(' + '|'.join(map(re.escape, names)) + r')\b')
    shared_pat = re.compile(r'\b(' + '|'.join(map(re.escape, shared))
                            + r')\b') if shared else None
    src_pat = {k: re.compile(r'\b' + re.escape(k) + r'\b')
               for k in (src_of or {})}
    total, mine = 0.0, False
    for _, name, sec in s['trace']['kernel_seq']:
        for k, p in src_pat.items():
            if p.search(name):
                mine = src_of[k]
        if pat.search(name):
            total += sec
        elif shared_pat is not None and shared_pat.search(name) and mine:
            total += sec
    return total / s['items']


def roofline(s, seconds, ops, nbytes, precision):
    """100 x the least time the work needs over the time it took, or
    None when nothing ran or nothing was counted."""
    if seconds <= 0 or (ops <= 0 and nbytes <= 0):
        return None
    return 100.0 * peaks.bound_s(ops, nbytes, precision) / seconds


def step_ideal_s(s):
    """Seconds the published peaks need for all counted operations of one
    item, each at the peak of the precision it runs in."""
    train = s['mode'] == 'train'
    passes = TRAIN_PASSES if train else 1
    t = 0.0
    for item in s['work']:
        for c in item['convs']:
            prec = 'f32' if train else 'bf16'
            t += passes * conv_ops_bytes(c)[0] / peaks.FLOPS[prec]
        conv_prec = 'tf32' if s['tf32']['cudnn'] else 'f32'
        lin_prec = 'tf32' if s['tf32']['matmul'] else 'f32'
        t += passes * item['dense']['conv'] / peaks.FLOPS[conv_prec]
        t += passes * item['dense']['linear'] / peaks.FLOPS[lin_prec]
    for groups, branch in pool_calls(s):
        prec = 'bf16' if branch == 'kernel' else 'f32'
        for p in groups:
            t += passes * pool_ops_bytes(p)[0] / peaks.FLOPS[prec]
    return t / len(s['work'])
