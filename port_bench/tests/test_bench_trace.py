"""The trace arithmetic on a synthetic trace: busy time as the union of
device intervals inside the window, idle share, launches, stage spans and
idle gaps named by the host op open at their start."""

from benchlib import readers
from benchlib.trace import summarize, union


def ev(name, cat, ts, dur):
    return {'name': name, 'cat': cat, 'ts': ts, 'dur': dur}


def test_union():
    total, merged = union([(0, 10), (5, 12), (20, 25), (21, 22)])
    assert total == 17 and merged == [[0, 12], [20, 25]]


def test_summary_and_idle_share():
    trace = {'traceEvents': [
        ev('bench_window', 'user_annotation', 100, 1000),
        ev('roi_head', 'user_annotation', 500, 400),
        ev('aten::nonzero', 'cpu_op', 600, 50),
        ev('k1', 'kernel', 50, 100),        # clipped to [100, 150]
        ev('k2', 'kernel', 200, 100),
        ev('k3', 'kernel', 250, 370),       # overlaps k2, ends at 620
        ev('copy', 'gpu_memcpy', 900, 50),
        ev('k4', 'kernel', 1050, 100),      # clipped to [1050, 1100]
        ev('roi_head', 'gpu_user_annotation', 510, 300)]}
    s = summarize(trace, ('roi_head',))
    assert s['window_s'] == 1000e-6
    assert abs(s['busy_s'] - (50 + 420 + 50 + 50) * 1e-6) < 1e-12
    assert s['launches'] == 4
    assert s['spans']['roi_head'] == {'host_s': 400e-6,
                                      'device_s': 300e-6, 'count': 1}
    gaps = dict(s['breakdown']['idle_gaps'])
    # the gap 620-900 starts inside aten::nonzero, within roi_head
    assert abs(gaps['aten::nonzero'] - 280e-6) < 1e-12
    assert abs(gaps['none'] - 150e-6) < 1e-12
    summary = {'mode': 'train', 'trace': s, 'items': 1, 'frames': 2}
    assert abs(readers.idle_share(summary, 'train') - 43.0) < 1e-9
    assert readers.idle_share(summary, 'infer') is None
    assert readers.launches_per_frame(summary, 'train') == 2.0
