"""Host ms per step inside the program's 'rpn' span (the model's layer in training)."""
from benchlib.readers import span_ms


def read(s):
    return span_ms(s, 'train', 'rpn')
