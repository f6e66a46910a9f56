"""AbDock's CDR-H3 docking model (``configs/test/dock_cdr.yml``: ``obj:
pred_x0``, structure only, the sequence held native) on the port's
sampling path, against the benchmark's plain reference
(``benchmark/reference/``: plain PyTorch, float32, no kernel, no JAX) on
the benchmark's seeded weights (``benchmark/harness/weights.py``).

On the CPU, at widths 16/8, two layers and four steps, on the docking
cell's crop (``benchmark/traffic/dock1000-L32.json``: a CDR-H3 of 12 and
20 antigen residues, L=32) fanned out to 8 trajectories (K1's attention
in blocks of 4 replicas):

* the initial state, the first reverse step, and two later steps from the
  port's kept state with the same draws, with their pRMSD and perplexity;
* the sequence unchanged at every step;
* the ``sample`` span's plan (objective, flags, encoder route, replicas,
  heads; the plain version records no K1 attention plan);
* the benchmark's own output check of the docking path (a tiny cell);
* the readers of ``k1_attn_fill_pct.sample`` and
  ``k1_attn_roofline.sample`` on made-up span records, and the roofline's
  operation and byte counts on a hand-counted case;
* the docking cell's files: the configuration holds the published model
  section of ``configs/test/dock_cdr.yml``.

On an NVIDIA GPU (marker ``cuda``; skips without a card), at the docking
cell's shape (1000 trajectories of one 32-residue crop, full widths, six
layers, 100 steps, bf16): graph replay equals eager sampling bit for bit,
K1's layer matches its plain version, and the attention plan the program
records (the library's) is the kernel's. Imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_dock.py
"""
import copy
import dataclasses
import json
import sys
import time
from pathlib import Path

import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / 'benchmark'
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import run_cell  # noqa: E402
from harness.manifest import (Cell, load_cell, load_json,  # noqa: E402
                              metric_reader)
from harness.reference_run import reference_model  # noqa: E402
from harness.trace import TraceView  # noqa: E402
from harness.traffic import (batch_rows, request_draws, rows_of,  # noqa: E402
                             step_draws, to_device)
from harness.weights import load_state, seeded_state  # noqa: E402
from reference.geometry import so3vec_to_rotation  # noqa: E402
from reference.models import DiffAb as RefDiffAb  # noqa: E402

from ab_opt_tpu_torch.models import get_model  # noqa: E402
from ab_opt_tpu_torch.ops import gablock as gb  # noqa: E402
from ab_opt_tpu_torch.utils import profiling  # noqa: E402
from ab_opt_tpu_torch.utils.bench_fixture import encoder_case  # noqa: E402
from ab_opt_tpu_torch.utils.profiling import Span  # noqa: E402

CELL = 'dock-poses1000-L32'
CONFIG = load_json(BENCH / 'configs' / 'diffab-dock_cdr.json')
TRAFFIC = load_json(BENCH / 'traffic' / 'dock1000-L32.json')
SEED = 2 ** 33 + 12345
REPS, STEPS = 8, 4
FLAGS = dict(sample_structure=True, sample_sequence=False)


def _tiny_model_cfg():
    cfg = copy.deepcopy(CONFIG['model'])
    cfg.update(res_feat_dim=16, pair_feat_dim=8, dtype='float32')
    cfg['diffusion'].update(num_steps=STEPS, eps_net_opt={'num_layers': 2})
    return cfg


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One intra-op thread for these small CPU problems: the suite's
    workers share the cores, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def dock():
    """One traced sampler call of the port on the CPU, the initial state
    its reverse loop started from, and the reference with the same
    weights, batch and draws."""
    cfg = _tiny_model_cfg()
    port = get_model(dict(cfg))
    weights = seeded_state(port, 11, 'cpu')
    load_state(port, weights)
    port.eval()
    ref = reference_model(RefDiffAb, cfg, weights, 'cpu')
    traffic = dict(TRAFFIC, fan_out=REPS)
    batch = to_device(batch_rows(traffic, cfg, SEED, 0, 1), 'cpu')
    L = batch['aa'].shape[1]
    draws = request_draws(SEED, 0, STEPS, REPS, L, 'cpu')
    start = {}
    loop = port._reverse_loop

    def kept_start(v, p, s, *a, **k):
        start['state'] = (v.clone(), p.clone(), s.clone())
        return loop(v, p, s, *a, **k)

    port._reverse_loop = kept_start
    profiling._RECORDS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = port.sample(batch, num_replicas=REPS, draws=draws,
                          keep_traj=True, **FLAGS)
    spans = profiling.recorded()
    del port._reverse_loop
    init = ref.initial_state(batch, rows_of(draws, torch.arange(REPS)),
                             REPS, **FLAGS)
    return dict(port=port, ref=ref, batch=batch, out=out, L=L,
                start=start['state'], init=init, spans=spans)


def _ref_step(d, k, before):
    """The reference's reverse step k (level STEPS - k) from ``before``
    (v, p normalized, s) with the request's draws of that step."""
    _, _, _, res_feat, pair_feat, mg, mr = d['init']
    dk = step_draws(SEED, 0, k, REPS, d['L'], 'cpu')
    with torch.no_grad():
        return d['ref'].reverse_step(*before, STEPS - k, res_feat, pair_feat,
                                     mg, mr, REPS, dk, None,
                                     *FLAGS.values())


def _assert_step(d, k, want):
    """The port's state after step k, its pRMSD and perplexity against the
    reference's step. Tolerances: positions 1e-4 A, where the two differ
    by float32 rounding alone (the plain K1 layer's products against the
    module's einsums, 1e-7 relative on positions of tens of A; the step
    scales its x0 prediction by a posterior coefficient at most 1);
    rotations, compared as matrices, 1e-2 at the worst residue and 1e-4
    at the median: the random-weight denoiser turns residues to within
    0.05 of an angle of pi, where the so3 vector the step composes its
    noise with loses precision to the square root of float32's epsilon
    (the worst residue of this case reads 1.7e-3); pRMSD and perplexity
    1e-5 relative, a softmax of logits that differ by rounding only
    (2e-7 here)."""
    ref, out, traj = d['ref'], d['out'], d['out']['traj']
    torch.testing.assert_close(traj['p'][k], ref.unnormalize_position(want[1]),
                               atol=1e-4, rtol=0)
    dR = (so3vec_to_rotation(traj['v'][k]) - so3vec_to_rotation(want[0])
          ).abs().amax((-1, -2))
    assert float(dR.max()) < 1e-2 and float(dR.median()) < 1e-4
    assert torch.equal(traj['s'][k], want[2])
    torch.testing.assert_close(out['prmsd'][k], want[3], atol=0, rtol=1e-5)
    torch.testing.assert_close(out['perplexity'][k], want[4], atol=0,
                               rtol=1e-5)


def test_initial_state_matches_reference(dock):
    """The same float32 operations in the same order (the reference copies
    the port's plain modules): within 1e-6, room for a library's
    reordering alone."""
    for got, want in zip(dock['start'], dock['init'][:3]):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert torch.equal(dock['start'][2], dock['init'][2])


def test_first_step_matches_reference(dock):
    _assert_step(dock, 0, _ref_step(dock, 0, dock['init'][:3]))


@pytest.mark.parametrize('k', [2, 3])
def test_later_step_from_kept_state_matches_reference(dock, k):
    """Level 2 (with a position draw) and level 1 (the last, without)."""
    traj, ref = dock['out']['traj'], dock['ref']
    before = (traj['v'][k - 1], ref.normalize_position(traj['p'][k - 1]),
              traj['s'][k - 1])
    _assert_step(dock, k, _ref_step(dock, k, before))


def test_sequence_unchanged_at_every_step(dock):
    native = dock['batch']['aa'].repeat_interleave(REPS, 0)
    assert bool((dock['out']['traj']['s'] == native[None]).all())
    assert torch.equal(dock['out']['s'], native)
    moved = dock['out']['traj']['p'][-1] - dock['port'].unnormalize_position(
        dock['start'][1])
    assert float(moved.abs().amax()) > 0     # the structure is sampled


def test_sample_span_records_the_plan(dock):
    """The plan of a CPU call: K1's route, run by its plain version, so
    no attention plan (``k1_rt``, ``k1_attn_qt``, ``k1_attn_rows``)."""
    (req,) = [s for s in dock['spans'] if s.name == 'sample']
    assert req.attrs == {
        'request': req.attrs['request'], 'N': REPS, 'L': 32,
        'obj': 'pred_x0', 'structure': True, 'sequence': False,
        'encoder': 'k1', 'reps': REPS, 'heads': 12}
    steps = [s for s in dock['spans'] if s.name == 'sample.step']
    assert [s.attrs['graph'] for s in steps] == ['eager'] * STEPS
    assert {dock['spans'][s.parent].name for s in steps} == {'sample'}


@pytest.mark.parametrize('ipa_impl,chain,reps,L,route', [
    ('auto', '0', 8, 32, 'k1'), ('auto', '0', 6, 300, 'k1'),
    ('pallas', '0', 8, 32, 'k4'), ('pallas_fused', '0', 8, 32, 'k1'),
    ('auto', '1', 8, 32, 'k5')])
def test_sampler_plan_on_the_cpu(dock, monkeypatch, ipa_impl, chain, reps,
                                 L, route):
    """The plan names the route the encoder takes (``encoder_route``,
    ``AB_OPT_FUSED_CHAIN`` included) and, on the CPU, no K1 plan."""
    port = dock['port']
    monkeypatch.setattr(port, 'cfg', dataclasses.replace(
        port.cfg, ipa_impl=ipa_impl))
    monkeypatch.setenv('AB_OPT_FUSED_CHAIN', chain)
    aa = torch.zeros((1, L), dtype=torch.long)
    assert port.sampler_plan(aa, reps, True, False) == {
        'obj': 'pred_x0', 'structure': True, 'sequence': False,
        'encoder': route, 'reps': reps, 'heads': 12}


def test_benchmark_check_of_the_docking_path():
    """The benchmark's output check, on a tiny docking cell run by the
    harness on the CPU: the port's plain path agrees with the reference
    (limits of 1e-3, as the harness's other tiny cells take), and the
    sequence, not sampled, is not compared."""
    traffic = dict(TRAFFIC, fan_out=REPS, pool=2, check_requests=2,
                   check_steps=2)
    del traffic['kernels']
    limits = {n: 1e-3 for n in ('first_pos_gap_rms_A', 'first_rot_gap_median',
                                'step_eps_gap', 'backbone_gap_A')}
    limits['context_changed'] = 0.0
    cell = Cell(name='tiny-dock', chips=1,
                config={'model': _tiny_model_cfg()}, traffic=traffic,
                limits=limits, end_to_end=[], per_layer=[])
    r = run_cell.run(cell, SEED, 0.2, False, 'cpu', time.perf_counter())
    assert r['correct'], r['checks']
    assert set(r['checks']) == set(limits)


def test_dock_cell_files():
    """The cell's configuration holds every key of the published model
    section, as written; its traffic samples structure only, and its
    limits leave out the sequence margin."""
    with open(ROOT / 'configs/test/dock_cdr.yml') as f:
        published = yaml.safe_load(f)
    for key, value in published['model'].items():
        assert CONFIG['model'][key] == value, key
    cell = load_cell(CELL)
    assert cell.chips == 1 and cell.traffic['fan_out'] == 1000
    assert (cell.traffic['sample_structure'],
            cell.traffic['sample_sequence']) == (True, False)
    assert set(cell.limits) == {'first_pos_gap_rms_A', 'first_rot_gap_median',
                                'step_eps_gap', 'context_changed',
                                'backbone_gap_A'}
    names = {m['name'] for m in cell.per_layer}
    assert {'k1_attn_fill_pct.sample', 'k1_attn_roofline.sample',
            'graph_step_pct.sample', 'k1_roofline'} <= names
    assert 'k1_host_us_per_layer' not in names


# ------------------------------------------------------------ the readers

US = 1_000


def _requests(*plans, steps=2):
    """A made-up span record: one closed request a plan (attributes of its
    ``sample`` span), each with ``steps`` closed reverse steps."""
    spans = []
    for i, plan in enumerate(plans):
        root = len(spans)
        spans.append(Span('sample', i * 10_000 * US, (i + 1) * 10_000 * US,
                          None, i, dict(plan, request=i)))
        for k in range(steps):
            t0 = spans[root].start + (1 + 2 * k) * US
            spans.append(Span('sample.step', t0, t0 + US, root, i,
                              {'t': steps - k, 'graph': 'replay'}))
    return spans


def _plan(N, L, reps, qt, rows, H=12):
    return {'N': N, 'L': L, 'heads': H, 'reps': reps, 'k1_rt': 4,
            'k1_attn_qt': qt, 'k1_attn_rows': rows, 'encoder': 'k1'}


DOCK = _plan(1000, 32, 1000, 128, 32.0)
CODESIGN = _plan(256, 256, 256, 128, 128.0)


def _view(kernels=()):
    return TraceView(list(kernels), list(kernels), [], 1.0, 0.0,
                     {'steps': 2}, None, {})


@pytest.mark.parametrize('plans,want', [
    ((DOCK,), 25.0), ((CODESIGN,), 100.0),
    # 1000 x 12 x 32 rows held of 1000 x 12 x 128 launched, and 256 x 12 x
    # 256 of 256 x 12 x 256: (384000 + 786432) / (1536000 + 786432).
    ((DOCK, CODESIGN), 100.0 * 1170432 / 2322432),
    # 144 rows in three 64-row tiles: 48 of a tile's 64 hold a residue.
    ((_plan(4, 144, 4, 64, 48.0),), 75.0),
    # A plan that packs a group's four 32-row replicas into one tile.
    ((_plan(1000, 32, 1000, 128, 128.0),), 100.0)])
def test_attention_fill_reader(monkeypatch, plans, want):
    monkeypatch.setattr(profiling, 'recorded', lambda: _requests(*plans))
    got = metric_reader('k1_attn_fill_pct.sample')(_view())
    assert got == pytest.approx(want)


def test_readers_read_nothing_without_a_k1_plan(monkeypatch):
    """A program from before the plan (a ``sample`` span with N and L
    alone), another route, open spans and no steps give None."""
    old = {'N': 16, 'L': 256}
    k4 = {'N': 16, 'L': 320, 'heads': 12, 'reps': 16, 'encoder': 'k4'}
    records = [_requests(old), _requests(k4), _requests(DOCK, steps=0),
               [Span('sample', 0, None, None, 0, dict(DOCK, request=0))],
               []]
    kernel = [('void (anonymous namespace)::k1_attn_kernel<P, 0>()', 0, 10)]
    for spans in records:
        monkeypatch.setattr(profiling, 'recorded', lambda: spans)
        for name in ('k1_attn_fill_pct.sample', 'k1_attn_roofline.sample'):
            assert metric_reader(name)(_view(kernel)) is None, (name, spans)
    monkeypatch.setattr(profiling, 'recorded', lambda: _requests(DOCK))
    assert metric_reader('k1_attn_roofline.sample')(_view()) is None


def _roofline_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'k1_attn_roofline_sample', BENCH / 'metrics' /
        'k1_attn_roofline.sample.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_attention_counts_by_hand():
    """N=8 trajectories of one complex, L=32, H=12. Operations: 2 x 8 x 12
    x 32^2 pairs x (58 logit terms + 56 values) = 2 x 98304 x 114 =
    22413312. Bytes (bf16): qa, ka, vv and o 4 x 8 x 32 x 768 = 786432
    values, alpha 8 x 12 x 1024 = 98304, the bias once 12 x 1024 =
    12288: 897024 values, 1794048 bytes."""
    m = _roofline_module()
    assert m.attention_flops(8, 32, 12) == 22413312
    assert m.attention_bytes(8, 32, 12, 8) == 1794048
    # Eight complexes of one trajectory each: the bias eight times.
    assert m.attention_bytes(8, 32, 12, 1) == 1794048 + 7 * 12288 * 2


def test_attention_roofline_reader(monkeypatch):
    """Two requests of the docking cell, 2 steps each, 6 layers: 24
    launches of 1 ms each. One launch's bytes bound it: 221,208,576 bytes
    (4 x 1000 x 32 x 768 + 1000 x 12 x 1024 + 12 x 1024 values) over
    3.35e12 B/s = 66.032 us, against 2.80e9 operations over 989e12 =
    2.83 us; so 6.6032% of the 24 ms."""
    monkeypatch.setattr(profiling, 'recorded', lambda: _requests(DOCK, DOCK))
    name = 'void (anonymous namespace)::k1_attn_kernel<P, 0>()'
    kernels = [(name, i * 2_000_000, 1_000_000) for i in range(24)]
    kernels.append(('void k1_p2n_kernel()', 0, 5_000_000))
    got = metric_reader('k1_attn_roofline.sample')(_view(kernels))
    assert got == pytest.approx(100.0 * 221208576 / 3.35e12 / 1e-3)


# ------------------------------------------------------------------ card

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA graphs and the kernels have '
                    'no CPU mode)')
    return torch.device('cuda')


def _flat(out):
    return {k: x for k, x in out.items() if k != 'traj'} | {
        'traj.' + k: x for k, x in out['traj'].items()}


@pytest.mark.cuda
def test_dock_graph_replay_equals_eager_on_card():
    """The cell's model and request: 1000 structure-only pred_x0
    trajectories of one crop, 100 steps. Eager, then the first graph call
    (capturing every level) and a second (replaying them): bit for bit,
    the sequence native throughout, and the replayed call's span records
    K1's plan with blocks of 4 replicas and a 128-row query tile."""
    dev = _card()
    cfg = CONFIG['model']
    model = get_model(dict(cfg))
    weights = seeded_state(model, 5, dev)
    model.to(dev)
    load_state(model, weights)
    model.eval()
    batch = to_device(batch_rows(TRAFFIC, cfg, SEED, 0, 1), dev)
    N, L = TRAFFIC['fan_out'], TRAFFIC['length']
    steps = model.cfg.num_steps

    def call(graph):
        draws = request_draws(SEED, 1, steps, N, L, dev)
        return model.sample(batch, num_replicas=N, draws=draws,
                            keep_traj=True, graph=graph, **FLAGS)

    want = _flat(call(False))
    first = _flat(call(True))
    profiling._RECORDS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        second = _flat(call(True))
    torch.cuda.synchronize()
    for got in (first, second):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    native = batch['aa'].repeat_interleave(N, 0)
    assert bool((want['traj.s'] == native[None]).all())
    assert len(model.step_graphs) == 1
    spans = profiling.recorded()
    (req,) = [s for s in spans if s.name == 'sample']
    assert {k: req.attrs[k] for k in ('obj', 'structure', 'sequence',
                                      'encoder', 'reps', 'k1_rt',
                                      'k1_attn_qt', 'k1_attn_rows')} == {
        'obj': 'pred_x0', 'structure': True, 'sequence': False,
        'encoder': 'k1', 'reps': 1000, 'k1_rt': 4, 'k1_attn_qt': 128,
        'k1_attn_rows': 32.0}
    assert [s.attrs['graph'] for s in spans
            if s.name == 'sample.step'] == ['replay'] * steps


@pytest.mark.cuda
def test_k1_matches_plain_at_dock_shape_on_card():
    """One layer at the cell's shape: 1000 trajectories of one complex,
    L=32 (one 128-row query tile a head and replica, 250 replica groups),
    against its plain version within K1's budget (atol and rtol 0.05, as
    at the other shapes); two launches bitwise equal."""
    dev = _card()
    args, bundles, biases = encoder_case(32, 1, 1000, 1, device=dev, seed=3)
    _, _, R9, t, x, z, _, mask, reps = args
    layer = (x, R9, t, z, biases[0], mask, bundles[0], reps)
    with torch.no_grad():
        got = gb.gablock_layer(*layer)
        again = gb.gablock_layer(*layer)
        torch.cuda.synchronize()
        ref = gb.gablock_layer_reference(*layer)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref, atol=0.05, rtol=0.05)


@pytest.mark.cuda
def test_attention_plan_on_card():
    """The library's attention plan is the kernel's (``k1_tiles.cuh``):
    128-row tiles at every L (AttnSmall up to L=128, AttnRing past it),
    each replica's rows in tiles of their own whatever the replicas a
    block serves; at the docking cell's shape 32 of a tile's 128 rows hold
    a residue, at the fan-out cells' L=256 all of them."""
    _card()
    for L in range(16, gb.MAX_L + 1, 16):
        for reps in (1, 2, 6, 1000):
            assert gb.attention_plan(L, reps) == (
                128, L / -(-L // 128)), (L, reps)
    assert gb.attention_plan(32, 1000) == (128, 32.0)
    assert gb.attention_plan(256, 256) == (128, 128.0)
