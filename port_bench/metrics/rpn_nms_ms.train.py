"""Host ms per item inside the program's 'rpn.nms' span: the RPN's rotated
BEV NMS over each entry (``boxes_overlap_bev`` and the suppression)."""
from benchlib.program_trace import span_ms


def read(s):
    return span_ms(s, 'train', 'rpn.nms')
