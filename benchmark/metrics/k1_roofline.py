"""K1's share of its roofline: the least time of the GABlock layers the
traced requests ran (the larger of their operations over 989 TFLOP/s and
their bytes over 3.35 TB/s) over the device time of K1's kernels."""


def read(view):
    t = view.kernel_seconds(r'\bk1_\w+_kernel\b')
    if t is None or 'k1_bound_s' not in view.flops:
        return None
    return 100.0 * view.flops['k1_bound_s'] / t
