"""ENet's and the heads' share of the card's f32 peak: their operations
(``vp_work.enet_ops``, ~481 GFLOP at 352 x 1216) at 67 TFLOP/s over the
median unprofiled frame's seconds (the gap between two returned clouds)."""
import statistics

from benchlib import peaks


def read(s):
    if s['mode'] != 'vp' or not s['item_host_s']:
        return None
    return 100.0 * s['work']['enet_ops'] / peaks.FLOPS['f32'] \
        / statistics.median(s['item_host_s'])
