"""Data parallelism of the port (``ab_opt_tpu_torch/parallel``) against the JAX
package's mesh and against one process, on the CPU.

The ranks are gloo processes started once per world size (4 and 2) through
``parallel/launch.py::spawn``; each runs a list of
``parallel/rehearse.py`` jobs (the targets live in the port: a spawned
child imports its target's module, and this module imports JAX). The JAX
side runs here on conftest's virtual 8-device mesh. The model is
``tests/test_parallel.py``'s small DiffAb (16/8 features, 1 layer, 4
steps, 8 bins) on N=8, L=16, each row generating a different number of
residues (1 to 8), so that the shards' masked-mean counts differ:

* the port's ``sharded_train_step`` at 4 ranks against JAX's
  ``sharded_train_step`` at ``make_mesh(8)`` with the bridged parameters
  and JAX's draws: every loss and the parameters after one Adam step with
  an active clip at 1e-5;
* the same step at 2 and 4 ranks against the one-process port step
  (1e-5), and the trap it avoids: shard means averaged over 2 ranks
  (``DistributedDataParallel``'s default) miss the global losses;
* two ``Trainer`` steps at 1 and 2 ranks from one seed, the draws (partial
  CDR masking included) made by the trainer (1e-5);
* ``DiffGNN`` with dropout 0 (2 layers, perturbed weights), two trainer
  steps at 2 ranks against one process: the losses at 1e-5, the first
  step's gradients within 1e-5 of their largest; its edge features are
  normalised over the global batch's edges, so the norms' sums, and
  their gradients, cross the ranks;
* the helpers: ``host_batch_slice`` against JAX's for every process count
  up to 8 and batch sizes 1-16 (and the ranks' own), ``auto_mesh_for_batch``
  against JAX's, ``global_batch_from_host_shards`` gathered back,
  ``shard_batch`` and ``replicate``,
  ``assert_replicated_params_equal`` raising on every rank when one rank's
  parameters move, the parameters equal on every rank after each step;
* ``sharded_sample_fn`` at 2 ranks: each rank's rows equal a one-process
  sample of those rows with that rank's generator, on separate rows and on
  the replica path, and the ranks' rows differ;
* ``DiffGNN`` at dropout 0.5 on rows that are the same on both ranks: the
  ranks' losses differ (each rank draws its own masks) where at dropout 0
  they are equal, and after ``validate`` (a val batch of 3 rows, rank 0's
  alone) the trainer's generator gives the same next draws on both ranks
  and in one process;
* ``rehearse.accumulate``, the one-process reference the card holds the
  bf16 step to, equals the step at 2 ranks.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from ab_opt_tpu_torch.models import DiffAb, DiffAbConfig, DiffGNN, DiffGNNConfig  # noqa: E402
from ab_opt_tpu_torch.parallel import distributed as TD  # noqa: E402
from ab_opt_tpu_torch.parallel import launch, rehearse  # noqa: E402
from ab_opt_tpu_torch.parallel.mesh import dp_size_for_batch  # noqa: E402
from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch  # noqa: E402
from ab_opt_tpu_torch.utils.convert import params_to_state_dict  # noqa: E402
from test_torch_gnn import gnn_batch  # noqa: E402
from test_torch_train import _loss_draws  # noqa: E402

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason='needs 8 virtual devices')

N, L = 8, 16
KW = dict(res_feat_dim=16, pair_feat_dim=8, num_steps=4, num_layers=1,
          num_bins=8)
WEIGHTS = {'rot': 1.0, 'pos': 1.0, 'seq': 1.0, 'dist': 1.0, 'prmsd': 0.1}
LR, CLIP = 1e-4, 1.0
TRAIN_CFG = {'batch_size': N, 'loss_weights': WEIGHTS, 'max_grad_norm': CLIP,
             'optimizer': {'type': 'adam', 'lr': LR}}
GNN_KW = dict(res_feat_dim=16, edge_feat_dim=8, hidden_size=16, num_steps=6,
              n_layers=2, dropout=0.0)
JAX_KEY = 1
TOL = dict(rtol=1e-5, atol=1e-7)


def _uneven(batch):
    """Row i generates residues [3, 4 + i): 1 to 8 residues a row."""
    gen = np.zeros_like(batch['generate_flag'])
    for i in range(len(gen)):
        gen[i, 3:4 + i] = True
    return dict(batch, generate_flag=gen)


@pytest.fixture(scope='module')
def setup():
    """The batch, the JAX model and params (perturbed), the port model
    spec, JAX's draws for key JAX_KEY and the GNN's batch and spec."""
    from ab_opt_tpu.models import DiffAb as JDiffAb
    from ab_opt_tpu.models import DiffAbConfig as JConfig
    batch = _uneven({k: v.numpy() for k, v in synthetic_batch(
        np.random.default_rng(0), N=N, L=L, n_ab=12, gen_lo=3,
        gen_hi=9).items()})
    jmodel = JDiffAb(JConfig(ipa_impl='einsum', **KW))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.jit(jmodel.init)(jax.random.key(0), batch))
    t, draws = _loss_draws(jax.random.key(JAX_KEY), N, L, KW['num_steps'])
    draws = (t.numpy(), {k: v.numpy() for k, v in draws.items()})
    spec = ('diffab', KW, params_to_state_dict(params))
    masked = ('diffab', dict(KW, mask_ratio_min=0.3, mask_ratio_max=1.0),
              spec[2])
    torch.manual_seed(0)
    gnn = DiffGNN(DiffGNNConfig(**GNN_KW))
    gbatch = _uneven(gnn_batch(3, N=N, L=24))
    # Perturbed, so that the first layer's coordinate update (its head
    # starts near zero) moves the second layer's edge norms: their
    # gradient then crosses the ranks.
    gspec = ('diff_gnn', GNN_KW, {
        k: v + 0.05 * torch.randn(v.shape) if v.is_floating_point() else v
        for k, v in gnn.state_dict().items()})
    # The same rows, and draws, in both ranks' halves.
    twin = {k: np.concatenate([v[:N // 2]] * 2) for k, v in gbatch.items()}
    t, d = gnn.loss_draws(N // 2, 24, torch.Generator().manual_seed(4))
    twin_draws = (np.concatenate([t.numpy()] * 2),
                  {k: np.concatenate([v.numpy()] * 2) for k, v in d.items()})
    drop = ('diff_gnn', dict(GNN_KW, dropout=0.5), gspec[2])
    return dict(batch=batch, jmodel=jmodel, params=params, draws=draws,
                spec=spec, masked=masked, gbatch=gbatch, gspec=gspec,
                twin=twin, twin_draws=twin_draws, drop=drop)


def _jobs(s, world):
    jobs = [('train', dict(model=s['spec'], train_cfg=TRAIN_CFG,
                           batches=[s['batch']], draws=[s['draws']],
                           via='step', grads=True)),
            ('helpers', dict(batch=s['batch']))]
    if world == 2:
        fan = {k: np.repeat(v[:1], N, 0) for k, v in s['batch'].items()}
        val = [{k: v[:n] for k, v in s['twin'].items()} for n in (3, 4)]
        streams = dict(train_cfg=TRAIN_CFG, batch=s['twin'],
                       draws=s['twin_draws'], val_batches=val, seed=8)
        jobs += [
            ('shard_mean_losses', dict(model=s['spec'], batch=s['batch'],
                                       draws=s['draws'], weights=WEIGHTS)),
            ('train/trainer', dict(model=s['masked'], train_cfg=TRAIN_CFG,
                                   batches=[s['batch'], s['batch']], seed=5)),
            ('train/gnn', dict(model=s['gspec'], train_cfg=TRAIN_CFG,
                               batches=[s['gbatch'], s['gbatch']], seed=6,
                               grads=True)),
            ('sample', dict(model=s['spec'], batch=s['batch'], seed=11)),
            ('sample/fanout', dict(model=s['spec'], batch=fan, seed=12,
                                   fanout=True)),
            ('dropout_streams', dict(streams, model=s['drop'])),
            ('dropout_streams/off', dict(streams, model=s['gspec']))]
    return jobs


@pytest.fixture(scope='module')
def ranks(setup):
    """{world size: [each rank's job results]}: one spawn a world size."""
    return {world: launch.spawn(rehearse.run_jobs, world,
                                args=(_jobs(setup, world),), threads=1,
                                timeout_s=120, wall_s=300)
            for world in (4, 2)}


@pytest.fixture(scope='module')
def one_process(setup):
    """The same jobs in this process (no process group: one device)."""
    jobs = [j for j in _jobs(setup, 2)
            if j[0].startswith(('train', 'dropout_streams'))]
    return rehearse.run_jobs(jobs)


def _same_losses(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _same_state(got, want, atol=1e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=atol, rtol=0, err_msg=k)


def test_shards_generate_different_counts(setup):
    counts = setup['batch']['generate_flag'].sum(1)
    for world in (2, 4):
        per = counts.reshape(world, -1).sum(1)
        assert len(set(per.tolist())) == world, per


def test_dp_step_at_4_ranks_matches_jax_mesh(setup, ranks):
    import optax
    from ab_opt_tpu.parallel import make_mesh, sharded_train_step
    jmodel, params = setup['jmodel'], setup['params']
    opt = optax.adam(LR)
    step = sharded_train_step(jmodel.loss, opt, make_mesh(8),
                              loss_weights=WEIGHTS, max_grad_norm=CLIP)
    p = jax.tree_util.tree_map(jnp.array, params)
    p2, _, want = step(p, opt.init(p), setup['batch'],
                       jax.random.key(JAX_KEY))
    assert bool(want.pop('_finite'))
    want = {k: float(v) for k, v in want.items()}
    got = ranks[4][0]['train']
    _same_losses(got['losses'][0], want)
    _same_state(got['state'], params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, p2)))
    # The clip was active: the reduced gradient's global norm was cut to
    # the clip.
    assert abs(float(got['grads'].norm()) - CLIP) < 1e-4


@pytest.mark.parametrize('world', [2, 4])
def test_dp_step_matches_one_process(ranks, one_process, world):
    got, want = ranks[world][0]['train'], one_process['train']
    _same_losses(got['losses'][0], want['losses'][0])
    _same_state(got['state'], want['state'])
    assert got['launches'][0]['plain'] > 0         # the CPU's plain versions


def test_shard_means_miss_the_global_losses(ranks, one_process):
    """The check above catches the trap: per-rank masked means averaged
    over the ranks are not the global batch's losses."""
    trap = ranks[2][0]['shard_mean_losses']
    want = one_process['train']['losses'][0]
    rel = {k: abs(trap[k] - want[k]) / abs(want[k])
           for k in ('rot', 'pos', 'seq', 'dist')}
    assert min(rel.values()) > 1e-3, rel
    with pytest.raises(AssertionError):
        _same_losses(trap, want)


def test_trainer_steps_at_1_and_2_ranks(ranks, one_process):
    got, want = ranks[2][0]['train/trainer'], one_process['train/trainer']
    assert len(got['losses']) == len(want['losses']) == 2
    for g, w in zip(got['losses'], want['losses']):
        _same_losses(g, w)
    _same_state(got['state'], want['state'])
    # Every rank reports the same global losses.
    assert ranks[2][1]['train/trainer']['losses'] == got['losses']


def test_gnn_steps_at_2_ranks(ranks, one_process):
    """The losses of both steps, and the first step's summed gradients
    (the parameters after two Adam steps amplify last-bit differences of
    near-zero gradients past 1e-5)."""
    got, want = ranks[2][0]['train/gnn'], one_process['train/gnn']
    for g, w in zip(got['losses'], want['losses']):
        _same_losses(g, w)
    scale = float(want['grads'].abs().max())
    np.testing.assert_allclose(got['grads'].numpy(), want['grads'].numpy(),
                               atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize('procs', range(1, 9))
def test_host_batch_slice_matches_jax(procs, monkeypatch):
    from ab_opt_tpu.parallel import distributed as JD
    monkeypatch.setattr(jax, 'process_count', lambda: procs)
    for i in range(procs):
        monkeypatch.setattr(jax, 'process_index', lambda i=i: i)
        for n in range(1, 17):
            mesh = TD.Mesh(procs, i)
            if n % procs:
                for fn in (lambda: JD.host_batch_slice(n),
                           lambda: TD.host_batch_slice(n, mesh)):
                    with pytest.raises(ValueError, match='not divisible'):
                        fn()
            else:
                assert TD.host_batch_slice(n, mesh) == JD.host_batch_slice(n)


def test_auto_mesh_for_batch_matches_jax():
    from ab_opt_tpu.parallel import auto_mesh_for_batch
    for n in range(1, 17):
        for limit in range(1, 9):
            want = auto_mesh_for_batch(n, limit).devices.size
            assert dp_size_for_batch(n, limit) == want, (n, limit)


@pytest.mark.parametrize('world', [2, 4])
def test_helpers_in_ranks(setup, ranks, world):
    results = [r['helpers'] for r in ranks[world]]
    for rank, r in enumerate(results):
        assert r['rank'] == rank
        for n in range(1, 17):
            want = (None if n % world else
                    (rank * n // world, (rank + 1) * n // world))
            assert r['slices'][n] == want
            assert r['meshes'][n] == dp_size_for_batch(n, world)
        # The perturbed parameters are caught on every rank.
        assert r['raised']
        # shard_batch broadcasts rank 0's batch and keeps this rank's rows;
        # replicate gives every rank rank 0's state.
        assert r['shard_batch'] and r['replicate']
        # The parameters stayed equal on every rank after the step.
        assert 'state' in ranks[world][0]['train']
    back = results[0]['gathered']
    for k, v in setup['batch'].items():
        np.testing.assert_array_equal(back[k].numpy(), v)


@pytest.mark.parametrize('job', ['sample', 'sample/fanout'])
def test_sharded_sampling_matches_one_process(setup, ranks, job):
    from ab_opt_tpu_torch.data.collate import to_device_batch
    spec = setup['spec']
    model = DiffAb(DiffAbConfig(**spec[1]))
    model.load_state_dict(spec[2])
    fanout = job.endswith('fanout')
    out = ranks[2][0][job]['out']
    batch = (setup['batch'] if not fanout else
             {k: np.repeat(v[:1], N, 0) for k, v in setup['batch'].items()})
    seed = 12 if fanout else 11
    half = N // 2
    for rank in range(2):
        rows = slice(rank * half, (rank + 1) * half)
        local = to_device_batch({k: v[rows] for k, v in batch.items()})
        kw = {}
        if fanout:
            local = {k: v[:1] for k, v in local.items()}
            kw['num_replicas'] = half
        gen = torch.Generator().manual_seed(seed + rank)
        # One thread, as the ranks run: the sampler's discrete draws (IGSO3
        # bins, argmax codes) turn a last-bit difference into another draw.
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with torch.no_grad():
                want = model.sample(local, generator=gen, **kw)
        finally:
            torch.set_num_threads(threads)
        for k in ('v', 'p', 's'):
            assert torch.equal(out[k][rows], want[k]), k
        for k in ('prmsd', 'perplexity'):
            assert torch.equal(out[k][:, rows], want[k]), k
    gen = torch.as_tensor(batch['generate_flag'][0])
    assert not torch.allclose(out['p'][0][gen], out['p'][half][gen])
    assert ranks[2][1][job]['out'] is None


def test_gnn_dropout_masks_differ_across_ranks(ranks):
    """Both ranks hold the same rows and draws: at dropout 0 their shares
    of the step's losses are equal, at 0.5 they differ, so each rank's
    rows get masks of their own."""
    on = [r['dropout_streams']['local'][0] for r in ranks[2]]
    off = [r['dropout_streams/off']['local'][0] for r in ranks[2]]
    assert off[0] == off[1]
    assert all(on[0][k] != on[1][k] for k in ('rot', 'pos', 'seq')), on


def test_gnn_dropout_keeps_the_trainer_generator_in_step(ranks, one_process):
    """Rank 0 alone computes the 3-row val batch's loss, with its dropout
    masks; the trainer's generator (the global t and noise) still gives the
    same next draws on both ranks, and the one-process run's."""
    on = [r['dropout_streams'] for r in ranks[2]]
    assert [len(r['local']) for r in on] == [3, 2]
    assert on[0]['val'] == on[1]['val'] and np.isfinite(on[0]['val'])
    assert torch.equal(on[0]['next'], on[1]['next'])
    assert torch.equal(on[0]['next'], one_process['dropout_streams']['next'])


def test_accumulated_parts_match_the_dp_step(setup, ranks):
    """The one-process reference of a 2-rank step's gradient (each half's
    backward over the global mask counts, accumulated) equals the step at
    2 ranks, losses and clipped gradients."""
    acc = rehearse.accumulate(setup['spec'], TRAIN_CFG, setup['batch'],
                              setup['draws'])
    got = ranks[2][0]['train']
    _same_losses(acc['losses'], got['losses'][0])
    scale = float(got['grads'].abs().max())
    np.testing.assert_allclose(acc['grads'].numpy(), got['grads'].numpy(),
                               atol=1e-5 * scale, rtol=0)
