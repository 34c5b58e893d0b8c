"""``cspn_iteration`` (``ops/cspn.py``, ``csrc/cspn.cu``): both CSPN
stages of a frame. Work: ``vp_work.cspn_ops_bytes`` from the map shapes
(bound by its bytes); time: the kernels' device time per frame, a frame
being ``2 x iters`` launches."""
from benchlib import work

KERNELS = ('cspn_tile_kernel', 'cspn_any_kernel')


def read(s):
    if s['mode'] != 'vp':
        return None
    seq = [sec for _, name, sec in s['trace']['kernel_seq']
           if any(k in name for k in KERNELS)]
    if not seq:
        return None
    per_frame = sum(seq) * s['work']['cspn_launches'] / len(seq)
    ops, nbytes = s['work']['cspn']
    return work.roofline(s, per_frame, ops, nbytes, 'f32')
