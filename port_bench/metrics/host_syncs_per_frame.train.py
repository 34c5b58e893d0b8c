"""Host syncs per frame in the profiled stretch: CUDA's synchronizing
operations counted by the program's tracing module under its spans."""
from benchlib.program_trace import syncs_per_frame


def read(s):
    return syncs_per_frame(s, 'train')
