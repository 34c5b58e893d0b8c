"""Shared arithmetic of the per-layer metric files (``metrics/*.py``). A
reader gets the traced run's summary: ``mode``, ``items`` (requests or
steps profiled), ``frames`` per item, ``trace`` (``trace.summarize``),
``work`` (the reference's counts per profiled item), ``item_host_s``
(host-clock seconds of every unprofiled item of the window), ``tf32``
(the program's TF32 switches), and the program's ``branch_counts`` and
``pool_counts`` over the profiled stretch. Each returns None when the
run has nothing for it to read."""

from __future__ import annotations

import statistics

from . import work


def span_ms(s, mode, *names):
    """Host milliseconds per item of the program's ``record_function``
    spans ``names`` (summed)."""
    if s['mode'] != mode:
        return None
    spans = s['trace']['spans']
    if not any(n in spans for n in names):
        return None
    return 1e3 * sum(spans[n]['host_s'] for n in names if n in spans) \
        / s['items']


def p90_ms(s, mode):
    """The 90th percentile of the unprofiled items' host-clock times:
    the highest percentile with ten items beyond it at a window's ~100
    requests."""
    if s['mode'] != mode or len(s['item_host_s']) < 10:
        return None
    return 1e3 * statistics.quantiles(s['item_host_s'], n=10)[-1]


def launches_per_frame(s, mode):
    if s['mode'] != mode or not s['trace']['launches']:
        return None
    return s['trace']['launches'] / (s['items'] * s['frames'])


def idle_share(s, mode):
    if s['mode'] != mode or s['trace']['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - s['trace']['busy_s'] / s['trace']['window_s'])


def mfu(s, mode):
    """100 x the seconds the published peaks need for one item's counted
    operations over the median unprofiled item's host-clock seconds."""
    if s['mode'] != mode or not s['item_host_s'] or not s['work']:
        return None
    return 100.0 * work.step_ideal_s(s) / statistics.median(s['item_host_s'])
