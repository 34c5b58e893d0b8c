"""The port's program spans and its host-sync counter.

Every span of the program opens through ``span(name)``; ``SPANS`` lists
their names. Tracing is on while ``torch.profiler`` records or a
``recording()`` block is open, and off otherwise. Off, ``span`` returns a
shared no-op context: no ``record_function`` call, no clock read, no
allocation. On, a span

- enters ``torch.profiler.record_function(name)``, so that it is an event
  of the exported Chrome trace;
- pushes its name on the thread's stack of open spans;
- adds one call and its inclusive host seconds to the registry;
- appends ``(name, start, end)`` to the timeline, in the Chrome trace's
  clock: microseconds since its ``baseTimeNanoseconds``, which Kineto
  takes as Unix time floored to a three-month boundary.

A span entered while one of the same name is open on the thread is not
counted again (and is no trace event). ``count({name: value})`` appends
values (a frame's counts, say) to the registry's counters while tracing is
on, and does nothing while it is off. Each recording
starts from an empty registry: the first span or count once tracing turns
on clears what an earlier recording left.

While on, CUDA's sync debug mode is 'warn', and its "called a synchronizing
CUDA operation" warnings are counted, not printed: under the innermost
program span open on the thread (on a thread with none open, such as
autograd's backward thread, on the main thread), under its site (the
``file:line`` of the innermost frame of this package) and as a stamp in
the timeline. A sync with no program span open is not counted. The first
span after tracing turns off puts the debug mode and the warning filters
back as they were.

    with trace.recording():
        detector(frames)
    snap = trace.snapshot()     # {'spans', 'sites', 'timeline', 'counters'}
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import time
import warnings

import torch
from torch.autograd import profiler as _autograd_profiler

SPANS = ('make_batch', 'voxelize', 'backbone_3d', 'sparse_plan', 'bev',
         'rpn', 'rpn.nms', 'rpn.anchor_targets', 'roi_head',
         'roi_head.grid_pool', 'loss', 'backward', 'allreduce_grads',
         'optimizer', 'postprocess_wbf', 'sync_bn', 'penet.enet',
         'penet.cspn', 'vp.depth2points', 'vp.copy')
COUNTERS = ('vp.sparse_pixels', 'vp.virtual_points', 'vp.thinned_points',
            'vp.fused_points')
SYNC_MESSAGE = 'called a synchronizing CUDA operation'
TRIMONTH_S = 7889238        # Kineto's base-time boundary, in seconds

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PACKAGE)
_THIS = os.path.abspath(__file__)
_NOOP = contextlib.nullcontext()


class _Registry:
    """What the open recording has seen, and the state its hooks replaced."""

    def __init__(self):
        self.lock = threading.Lock()
        self.recording = 0          # open recording() blocks
        self.hooked = False
        self.saved = None           # (warning filters, showwarning, mode)
        self.base_ns = 0
        self.stacks = {}            # thread ident -> names of open spans
        self.clear()

    def clear(self):
        self.spans = {}             # name -> [calls, host ns, syncs]
        self.sites = collections.Counter()
        self.timeline = []          # (name, start us, end us)
        self.syncs = []             # (us, span, site)
        self.counters = {}          # name -> [values]

    def stack(self):
        ident = threading.get_ident()
        s = self.stacks.get(ident)
        if s is None:
            s = self.stacks[ident] = []
        return s

    def us(self, ns):
        return (ns - self.base_ns) / 1e3


_reg = _Registry()


def enabled() -> bool:
    """Whether tracing is on (``torch.profiler`` or ``recording()``)."""
    return _autograd_profiler._is_profiler_enabled or bool(_reg.recording)


def span(name: str):
    """A context manager that opens the program span ``name`` (one of
    ``SPANS``) while tracing is on, and does nothing while it is off."""
    if enabled():
        stack = _reg.stack()
        if name in stack:
            return _NOOP
        if not _reg.hooked:
            _hook()
        return _Span(name, stack)
    if _reg.hooked:
        _unhook()
    return _NOOP


class _Span:
    __slots__ = ('name', 'stack', 'rf', 't0')

    def __init__(self, name, stack):
        self.name, self.stack = name, stack

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.stack.append(self.name)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.stack.pop()
        self.rf.__exit__(*exc)
        with _reg.lock:
            e = _reg.spans.setdefault(self.name, [0, 0, 0])
            e[0] += 1
            e[1] += t1 - self.t0
            _reg.timeline.append((self.name, _reg.us(self.t0), _reg.us(t1)))
        return False


def count(values):
    """Append each value of ``values`` ({name: value}, names of
    ``COUNTERS``) to its counter, all under one lock, while tracing is on;
    nothing while it is off. The values of one call keep one index across
    their counters."""
    if not enabled():
        return
    if not _reg.hooked:
        _hook()
    with _reg.lock:
        for name, value in values.items():
            _reg.counters.setdefault(name, []).append(value)


@contextlib.contextmanager
def recording():
    """Tracing on inside the block, without the profiler (nestable)."""
    _reg.recording += 1
    try:
        yield
    finally:
        _reg.recording -= 1
        if not _reg.recording and not \
                _autograd_profiler._is_profiler_enabled and _reg.hooked:
            _unhook()


def snapshot():
    """A copy of the registry: ``spans`` {name: {'calls', 'host_s',
    'syncs'}}, ``sites`` {'file:line': syncs}, ``timeline`` {'spans':
    [(name, start, end)], 'syncs': [(t, span, site)]}, times in the
    Chrome trace's microseconds, and ``counters`` {name: [values]}."""
    with _reg.lock:
        return {
            'spans': {n: {'calls': c, 'host_s': ns / 1e9, 'syncs': s}
                      for n, (c, ns, s) in _reg.spans.items()},
            'sites': dict(_reg.sites),
            'timeline': {'spans': list(_reg.timeline),
                         'syncs': list(_reg.syncs)},
            'counters': {n: list(v) for n, v in _reg.counters.items()}}


def reset():
    """Clear the registry; with tracing off, also put back what its hooks
    replaced."""
    if _reg.hooked and not (_autograd_profiler._is_profiler_enabled
                            or _reg.recording):
        _unhook()
    with _reg.lock:
        _reg.clear()


def _hook():
    """Tracing turned on: a fresh registry, the trace's base time, CUDA's
    sync warnings on and routed to ``_on_warning``."""
    with _reg.lock:
        _reg.clear()
        _reg.base_ns = (time.time_ns() // (TRIMONTH_S * 10 ** 9)) \
            * TRIMONTH_S * 10 ** 9
    mode = None
    if torch.cuda.is_initialized():
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode('warn')
    _reg.saved = (list(warnings.filters), warnings.showwarning, mode)
    warnings.filterwarnings('always', message=SYNC_MESSAGE)
    warnings.showwarning = _on_warning
    _reg.hooked = True


def _unhook():
    filters, show, mode = _reg.saved
    _reg.hooked, _reg.saved = False, None
    warnings.filters[:] = filters
    warnings._filters_mutated()
    warnings.showwarning = show
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)


def _site(filename, lineno):
    """``file:line`` of the innermost frame in this package, else of the
    warning's own frame; relative to the repository's root."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PACKAGE + os.sep) and path != _THIS:
            filename, lineno = path, f.f_lineno
            break
        f = f.f_back
    if filename.startswith(_ROOT + os.sep):
        filename = filename[len(_ROOT) + 1:]
    return f'{filename}:{lineno}'


def _on_warning(message, category, filename, lineno, file=None, line=None):
    if not str(message).startswith(SYNC_MESSAGE):
        show = _reg.saved[1] if _reg.saved else warnings._showwarning_orig
        return show(message, category, filename, lineno, file, line)
    t = time.time_ns()
    stack = _reg.stacks.get(threading.get_ident()) or \
        _reg.stacks.get(threading.main_thread().ident)
    if not stack:
        return None
    site = _site(filename, lineno)
    with _reg.lock:
        e = _reg.spans.setdefault(stack[-1], [0, 0, 0])
        e[2] += 1
        _reg.sites[site] += 1
        _reg.syncs.append((_reg.us(t), stack[-1], site))
    return None
