"""The training step's share of the chip's peak: the forward and
backward operations of the traced steps over the traced window and the
peak of the configuration's dtype (989 TFLOP/s bf16, 67 float32)."""
from harness.flops import PEAK_FLOPS


def read(view):
    if not view.flops.get('model') or view.window_s <= 0:
        return None
    peak = PEAK_FLOPS[view.flops['dtype']]
    return 100.0 * view.flops['model'] / (view.window_s * peak)
