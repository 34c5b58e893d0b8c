"""``gather_rows`` (``ops/gather_rows.py``, ``csrc/gather_rows.cu``): the
training pool's row gathers, forward and the CSR backward. Pure data
movement: the bound is the rows' bytes, each moved once each way."""
from benchlib import work

KERNELS = ('gather_rows_fwd_kernel', 'csr_count_kernel', 'csr_scan_kernel',
           'csr_scatter_kernel', 'csr_sort_warp_kernel',
           'csr_sort_long_kernel', 'rows_sum_warp_kernel',
           'rows_sum_long_kernel')


def read(s):
    if s['mode'] != 'train':
        return None
    nbytes = sum(2 * work.gather_bytes(g) for item in s['work']
                 for g in item['gathers']) / len(s['work'])
    return work.roofline(s, work.kernel_seconds(s, KERNELS), 0.0, nbytes,
                         'f32')
