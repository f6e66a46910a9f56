"""The sampler's share of the chip's peak: the model operations of the
traced requests (encode, then each step's denoiser: the mix-in, the
GABlock layers, the heads) over the traced window and the peak of the
configuration's dtype."""
from harness.flops import PEAK_FLOPS


def read(view):
    if not view.flops.get('model') or view.window_s <= 0:
        return None
    peak = PEAK_FLOPS[view.flops['dtype']]
    return 100.0 * view.flops['model'] / (view.window_s * peak)
