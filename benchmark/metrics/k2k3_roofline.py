"""K2 and K3's share of their roofline: the least time of the traced
steps' attention calls (each layer's forward, 4 pairs 64 operations, and
backward, 8 pairs 64, with their bytes) over the device time of their
kernels (the tile route's or the CUDA-core route's)."""


def read(view):
    t = view.kernel_seconds(r'\b(k2_tile_kernel|k3_tile_kernel|fwd_kernel'
                            r'|bwd_rows_kernel|bwd_cols_kernel)\b')
    if t is None or 'k2k3_bound_s' not in view.flops:
        return None
    return 100.0 * view.flops['k2k3_bound_s'] / t
