"""Host ms per item inside the program's 'sparse_plan' span: the sparse
convs' keys, sorts, lookups, band plans and patches, neighbor and transpose
maps (``ops/sparse.py``), everything before a conv's kernels run."""
from benchlib.program_trace import span_ms


def read(s):
    return span_ms(s, 'infer', 'sparse_plan')
