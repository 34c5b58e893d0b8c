"""Host ms per request of the serve layer's own spans (make_batch and
postprocess_wbf, ``virconv_tpu_torch/serve.py``)."""
from benchlib.readers import span_ms


def read(s):
    return span_ms(s, 'infer', 'make_batch', 'postprocess_wbf')
