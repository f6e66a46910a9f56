"""The operation and byte counts against hand counts at small shapes,
and the trace arithmetic on made-up events."""
import pytest

from bench_tiny import BENCH  # noqa: F401
from harness import flops
from harness.trace import TraceView, _union_ns, breakdown
from harness.manifest import metric_reader


def test_gablock_flops_by_hand():
    # N=1, L=2, F=1, Cz=1: projections 2*2*1*2016; pairs 2*12*4*(58+56+1);
    # output transform 2*2*(12*(1+32+56))*1; transition 6*2*1*1.
    got = flops.gablock_flops(1, 2, F=1, Cz=1)
    want = 8064 + 11040 + 4272 + 12
    assert got == want


def test_gablock_at_the_cell_size():
    # ~1.42e11 operations a layer at 256 x L=256, bound by operations.
    f = flops.gablock_flops(256, 256)
    assert 1.40e11 < f < 1.45e11
    b = flops.gablock_bytes(256, 256, 256)
    assert f / flops.PEAK_FLOPS['bfloat16'] > b / flops.PEAK_BYTES


def test_attention_counts_by_hand():
    pairs = 2 * 12 * 3 * 3
    rows = 2 * 3 * 12 * 64
    assert flops.attention_fwd(2, 3) == (4 * pairs * 64,
                                         (4 * rows + 2 * pairs) * 2)
    assert flops.attention_bwd(2, 3) == (8 * pairs * 64,
                                         (7 * rows + 3 * pairs) * 2)


def test_bound_takes_the_larger():
    assert flops.bound_s(989e12, 0) == pytest.approx(1.0)
    assert flops.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert flops.bound_s(67e12, 0, 'float32') == pytest.approx(1.0)


def test_gnn_flops_scale_with_edges():
    m = {'hidden_size': 8, 'edge_feat_dim': 8, 'res_feat_dim': 8,
         'num_atoms': 3, 'n_layers': 2, 'hotspot': True}
    a = flops.gnn_train_flops(m, 1, 4, 0, 0)
    b = flops.gnn_train_flops(m, 1, 4, 1, 0)
    # One ctx edge adds the edge and coordinate MLPs of the 3 GCLs:
    # 2*(2*8 + 18 + 8)*8 + 2*8*8 + 2*8*8 + 2*8*3, forward and backward.
    per_edge = 2 * 42 * 8 + 2 * 64 + 2 * 64 + 2 * 24
    assert b - a == 3 * 3 * per_edge


def _view(device_ops, window_s, kernels=None, flops_=None, counts=None):
    busy_ns, _ = _union_ns((s, s + d) for _, s, d in device_ops)
    return TraceView(kernels if kernels is not None else device_ops,
                     device_ops, [('aten::mm', 0, 10_000)], window_s,
                     busy_ns * 1e-9, counts or {'steps': 2}, None,
                     flops_ or {})


def test_idle_share_of_made_up_events():
    # Busy [0, 3) and [2, 5) overlap: 5 us; [8, 10): 2 us; window 10 us.
    ops = [('a', 0, 3000), ('b', 2000, 3000), ('c', 8000, 2000)]
    v = _view(ops, 10e-6)
    assert v.busy_s == pytest.approx(7e-6)
    for name in ('device_idle_pct.sample', 'device_idle_pct.train'):
        assert metric_reader(name)(v) == pytest.approx(30.0)
    assert metric_reader('launches_per_step.train')(v) == 1.5
    gaps = breakdown(v)['idle_gaps']
    assert gaps == [['aten::mm', pytest.approx(3e-6)]]
    assert breakdown(v)['device_ops'][0] == ['a', pytest.approx(3e-6)]


def test_readers_return_nothing_without_their_kernels():
    v = _view([('other_kernel', 0, 1000)], 1e-3,
              flops_={'k1_bound_s': 1e-6, 'k2k3_bound_s': 1e-6})
    assert metric_reader('k1_roofline')(v) is None
    assert metric_reader('k2k3_roofline')(v) is None
    k = [('void k1_gemm_kernel<2>(float*)', 0, 4000),
         ('k3_tile_kernel', 0, 1000)]
    v = _view(k, 1e-3, flops_={'k1_bound_s': 1e-6, 'k2k3_bound_s': 5e-7})
    assert metric_reader('k1_roofline')(v) == pytest.approx(25.0)
    assert metric_reader('k2k3_roofline')(v) == pytest.approx(50.0)
