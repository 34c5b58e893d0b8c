"""Host ms per step of the program's backward span (``train/trainer.py``)."""
from benchlib.readers import span_ms


def read(s):
    return span_ms(s, 'train', 'backward')
