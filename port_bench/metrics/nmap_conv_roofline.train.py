"""``nmap_conv`` (forward, input gradient) and ``nmap_conv_dw`` in
training (``ops/nmap_conv.py``, ``csrc/gather_conv.cu``, ``band_conv.cu``):
the strided and the 2D image-plane convs, and the patch terms of the band
convs' weight gradient (whose work counts under the band conv). Work:
three passes over the reference's neighbor pairs at f32."""
from benchlib import work

KERNELS = ('windowed_row_kernel', 'windowed_tile_kernel',
           'windowed_fma_kernel', 'nmap_tile_kernel', 'nmap_dw_src_kernel')
SHARED = ('band_conv_dw_kernel', 'band_conv_dw_sum_kernel')
SOURCES = {'band_conv_dw_src_kernel': False, 'nmap_dw_src_kernel': True}


def read(s):
    if s['mode'] != 'train':
        return None
    n_nmap = sum(not work.band_route(c, True) for c in s['work'][0]['convs'])
    if s['branch_counts'].get('nmap_train', 0) != n_nmap:
        return None
    ops, nbytes = work.sparse_work(s, 'nmap')
    sec = work.kernel_seconds(s, KERNELS, SHARED, SOURCES)
    return work.roofline(s, sec, ops, nbytes, 'f32')
