"""Kernel launches per frame in the profiled stretch: the trace's kernels
over the frames whose forwards ran in it (the ``penet.enet`` spans)."""


def read(s):
    if s['mode'] != 'vp' or not s['trace']['launches']:
        return None
    span = s['trace']['spans'].get('penet.enet')
    if not span or not span['count']:
        return None
    return s['trace']['launches'] / span['count']
