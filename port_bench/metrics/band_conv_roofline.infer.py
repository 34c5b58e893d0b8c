"""K1 (``ops/band_conv.py``, ``csrc/band_conv.cu``: the band conv and its
gather patch) at inference: every sparse conv of the request runs on it.
Work: the reference's neighbor pairs at bf16 operands; time: the kernels'
device time. None when a conv left the band path (the program's
``nmap_slow`` counter)."""
from benchlib import work

KERNELS = ('band_conv_row_kernel', 'band_conv_kernel', 'patch_tile_kernel',
           'patch_row_kernel')


def read(s):
    if s['mode'] != 'infer' or s['branch_counts'].get('nmap_slow', 0):
        return None
    ops, nbytes = work.sparse_work(s, 'band')
    return work.roofline(s, work.kernel_seconds(s, KERNELS), ops, nbytes,
                         'bf16')
