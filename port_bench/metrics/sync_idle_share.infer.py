"""Percent of the device-idle time between the profiled stretch's first and
last kernel that lies in idle gaps holding a host sync stamp (the rest is
dispatch idle)."""
from benchlib.program_trace import sync_idle_share


def read(s):
    return sync_idle_share(s, 'infer')
