"""Host ms per request inside the program's 'backbone_3d' span (the model's layer at inference)."""
from benchlib.readers import span_ms


def read(s):
    return span_ms(s, 'infer', 'backbone_3d')
