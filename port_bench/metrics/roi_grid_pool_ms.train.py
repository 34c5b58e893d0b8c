"""Host ms per item inside the program's 'roi_head.grid_pool' span: every
ROI grid pool call of every stage (tables, query points, plan, kernel or
probe path, the MLPs)."""
from benchlib.program_trace import span_ms


def read(s):
    return span_ms(s, 'train', 'roi_head.grid_pool')
