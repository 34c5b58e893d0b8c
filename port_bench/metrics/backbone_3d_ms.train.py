"""Host ms per step inside the program's 'backbone_3d' span (the model's layer in training)."""
from benchlib.readers import span_ms


def read(s):
    return span_ms(s, 'train', 'backbone_3d')
