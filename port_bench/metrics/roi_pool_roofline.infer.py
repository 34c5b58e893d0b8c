"""K2+K3, the ROI pooling kernel (``ops/roi_pool.py``, ``csrc/roi_pool.cu``),
at inference. Work: the reference's (query, voxel) pairs of exactly the
grid pool calls that ran on the kernel in the traced stretch (each program
call is marked with its branch by the program's pool counter; the others
take the probe path)."""
from benchlib import work

KERNELS = ('roi_pool_kernel',)


def read(s):
    if s['mode'] != 'infer':
        return None
    ops = nbytes = 0.0
    ran = False
    for groups, branch in work.pool_calls(s):
        if branch == 'kernel':
            ran = True
            for p in groups:
                o, b = work.pool_ops_bytes(p)
                ops += o
                nbytes += b
    if not ran:
        return None
    n = len(s['work'])
    return work.roofline(s, work.kernel_seconds(s, KERNELS), ops / n,
                         nbytes / n, 'bf16')
