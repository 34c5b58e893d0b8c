"""Kernel ms per frame inside the program's ``penet.cspn`` span
(``PENetC2.propagate``: both CSPN stages and their blends): the device
time of the kernels in the span's device interval, summed, from the
trace."""
from benchlib.vp_work import span_kernel_ms


def read(s):
    return span_kernel_ms(s, 'penet.cspn')
