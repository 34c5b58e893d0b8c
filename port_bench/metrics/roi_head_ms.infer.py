"""Host ms per request inside the program's 'roi_head' span (the model's layer at inference)."""
from benchlib.readers import span_ms


def read(s):
    return span_ms(s, 'infer', 'roi_head')
