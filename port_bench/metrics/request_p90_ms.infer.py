"""90th percentile of the host-clock request time over the traced run's
unprofiled requests (serve.Detector.__call__, closed loop)."""
from benchlib.readers import p90_ms


def read(s):
    return p90_ms(s, 'infer')
