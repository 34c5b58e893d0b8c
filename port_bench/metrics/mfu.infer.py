"""The whole request's share of the chip's published peaks (see readers.mfu)."""
from benchlib.readers import mfu


def read(s):
    return mfu(s, 'infer')
