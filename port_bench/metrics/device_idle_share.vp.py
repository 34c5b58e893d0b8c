"""Percent of the profiled stretch in which no device operation ran."""
from benchlib.readers import idle_share


def read(s):
    return idle_share(s, 'vp')
