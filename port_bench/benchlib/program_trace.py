"""Per-layer metrics read from the program's own tracing module
(``virconv_tpu_torch.utils.trace``) after the traced stretch.

``torch.profiler`` turns that module on, and each recording starts from an
empty registry, so its snapshot holds the profiled requests or steps alone:
the program's spans (calls, host seconds, the host syncs counted under
each) and the timeline of spans and sync stamps on the Chrome trace's
clock. A program without the module gives None, as does a run of the other
mode."""

from __future__ import annotations

import bisect

from .trace import union


def program_snapshot():
    try:
        from virconv_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def _snapshot(s, mode):
    if s['mode'] != mode:
        return None
    snap = program_snapshot()
    return snap if snap and snap['spans'] else None


def span_ms(s, mode, name):
    """Host milliseconds per item inside the program span ``name``."""
    snap = _snapshot(s, mode)
    if snap is None or name not in snap['spans']:
        return None
    return 1e3 * snap['spans'][name]['host_s'] / s['items']


def syncs_per_frame(s, mode):
    """Host syncs counted under the program's spans, per frame."""
    snap = _snapshot(s, mode)
    if snap is None:
        return None
    return sum(e['syncs'] for e in snap['spans'].values()) \
        / (s['items'] * s['frames'])


def sync_idle(kernel_seq, stamps):
    """(idle, sync idle) microseconds between the first kernel's start and
    the last one's end: idle is the gaps between merged kernel intervals,
    sync idle the gaps that hold at least one of the sync ``stamps``."""
    _, merged = union((ts, ts + sec * 1e6) for ts, _, sec in kernel_seq)
    stamps = sorted(stamps)
    idle = sync = 0.0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        idle += b - a
        i = bisect.bisect_left(stamps, a)
        if i < len(stamps) and stamps[i] <= b:
            sync += b - a
    return idle, sync


def sync_idle_share(s, mode):
    """Percent of the device-idle time between the stretch's first and last
    kernel that lies in gaps holding a host sync; the rest is dispatch."""
    snap = _snapshot(s, mode)
    if snap is None or not s['trace']['kernel_seq']:
        return None
    idle, sync = sync_idle(s['trace']['kernel_seq'],
                           [t for t, _, _ in snap['timeline']['syncs']])
    return 100.0 * sync / idle if idle > 0 else None
