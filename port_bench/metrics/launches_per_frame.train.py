"""Kernel launches per frame in the profiled stretch (host dispatch)."""
from benchlib.readers import launches_per_frame


def read(s):
    return launches_per_frame(s, 'train')
