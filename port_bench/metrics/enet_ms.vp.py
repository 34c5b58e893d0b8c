"""Kernel ms per frame inside the program's ``penet.enet`` span
(``PENetC2.heads``: ENet and the propagation heads): the device time of
the kernels in the span's device interval, summed, from the trace; the
waits between its launches are not counted."""
from benchlib.vp_work import span_kernel_ms


def read(s):
    return span_kernel_ms(s, 'penet.enet')
