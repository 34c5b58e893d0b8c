"""The work the reference finds while it runs: every sparse conv (its
neighbor pairs, rows and widths), every ROI pool group (its query-voxel
pairs) and every row gather of the training pool. The benchmark's work
functions (``benchlib/work.py``) turn it into operations and bytes.
Counting is off unless a ``Tally`` is active (``with tally:``)."""

from __future__ import annotations

import torch

_ACTIVE = [None]


class Tally:
    def __init__(self):
        self.convs = []     # dicts: subm, taps, pairs, n_in, n_out, c_in, c_out
        self.pools = []     # dicts: stride, q, pairs, queries, n_src, mid
        self.gathers = []   # dicts: n, m, c

    def __enter__(self):
        _ACTIVE[0] = self
        return self

    def __exit__(self, *exc):
        _ACTIVE[0] = None


def conv(nmap, out_mask, weights, subm: bool):
    t = _ACTIVE[0]
    if t is None:
        return
    with torch.no_grad():
        hit = (nmap >= 0) & out_mask[:, None]
        t.convs.append({
            'subm': subm, 'taps': int(nmap.shape[1]),
            'pairs': int(hit.sum()),
            'n_in': int(torch.unique(nmap[hit]).numel()),
            'n_out': int(out_mask.sum()),
            'c_in': int(weights.shape[1]), 'c_out': int(weights.shape[2])})


def pool(stride, q, idx, valid, query_mask, n_src, mid):
    t = _ACTIVE[0]
    if t is None:
        return
    with torch.no_grad():
        t.pools.append({'stride': int(stride), 'q': q, 'pairs': int(valid.sum()),
                        'queries': int(query_mask.sum()),
                        'n_src': int(n_src), 'mid': int(mid)})


def gather(n, valid, c):
    t = _ACTIVE[0]
    if t is None:
        return
    t.gathers.append({'n': int(n), 'm': int(valid.sum()), 'c': int(c)})
