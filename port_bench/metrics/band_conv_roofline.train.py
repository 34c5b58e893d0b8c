"""K1 forward and input gradient and K4 (``band_conv_dw``) in training:
the 3D submanifold convs (``csrc/band_conv.cu``). K4's sums kernels, which
``nmap_conv_dw`` shares, count here when K4's source pass launched last.
Work: three passes over the reference's neighbor pairs at f32. None
unless the program's band-route count equals the reference's."""
from benchlib import work

KERNELS = ('band_conv_row_kernel', 'band_conv_kernel', 'patch_tile_kernel',
           'patch_row_kernel', 'band_conv_dw_src_kernel')
SHARED = ('band_conv_dw_kernel', 'band_conv_dw_sum_kernel')
SOURCES = {'band_conv_dw_src_kernel': True, 'nmap_dw_src_kernel': False}


def read(s):
    if s['mode'] != 'train':
        return None
    n_band = sum(work.band_route(c, True) for c in s['work'][0]['convs'])
    if s['branch_counts'].get('band_train', 0) != n_band:
        return None
    ops, nbytes = work.sparse_work(s, 'band')
    sec = work.kernel_seconds(s, KERNELS, SHARED, SOURCES)
    return work.roofline(s, sec, ops, nbytes, 'f32')
