"""The rest of the JAX BatchedSampler in the port, against the JAX package on
the CPU (float32, L=24, 2 layers, 4 steps, the draws of the JAX key
re-derived the way its functions split it and fed to the port):

* ``PositionTransition.ddim_step`` at 1e-6;
* strided sampling (``DiffAb.sample(stride=2)`` and ``stride=3``, whose
  last jump is shorter), the trajectory (``keep_traj``) against JAX
  ``sample(stride=...)``: the first jump on all but its generated positions
  (float32 cannot fix them there, see the test), every later jump whole;
* ``DiffAb.optimize`` at two ``opt_step``s, every step of the trajectory
  against JAX ``optimize``;
* ``DiffAbConfig(ipa_impl='pallas')`` sampling (the eager encoder over K4's
  plain version) against JAX ``ipa_impl='pallas'`` (K4 in interpret mode);
Positions and rotation matrices at 1e-3, codes exact. Also
``BatchedSampler(device='cpu')`` with each of ``opt_step``, ``stride``,
``sample_structure=False`` and ``sample_sequence=False``,
``replicate_batch`` against JAX, and the accepted ``ipa_impl`` values.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from ab_opt_tpu.geometry import so3vec_to_rotation as j_rot  # noqa: E402
from ab_opt_tpu_torch.geometry import so3vec_to_rotation as t_rot  # noqa: E402
from ab_opt_tpu_torch.models import DiffAb, DiffAbConfig  # noqa: E402
from ab_opt_tpu_torch.ops import gablock  # noqa: E402
from ab_opt_tpu_torch.ops import ipa_attention as ia  # noqa: E402
from ab_opt_tpu_torch.utils.convert import params_to_state_dict  # noqa: E402
from test_torch_model import small_models  # noqa: E402
from test_torch_sample import _jax_draws  # noqa: E402

L, LAYERS, STEPS = 24, 2, 4
tt = lambda a: torch.from_numpy(np.array(a))


@pytest.fixture(scope='module')
def models():
    """small_models at L=24, 2 layers, 4 steps, flax's own init (the case
    tests/test_torch_sample.py follows whole, clear of the log map's clamp
    near pi)."""
    return small_models(L=L, num_layers=LAYERS, num_steps=STEPS, noise=0.0)


def _assert_states(got, want, prefix=''):
    """Positions (A) and rotation matrices at 1e-3, codes exact."""
    np.testing.assert_allclose(got['p'].numpy(), np.asarray(want['p']),
                               atol=1e-3, rtol=0, err_msg=prefix + 'p')
    np.testing.assert_allclose(t_rot(got['v']).numpy(),
                               np.asarray(j_rot(want['v'])), atol=1e-3,
                               rtol=0, err_msg=prefix + 'v')
    np.testing.assert_array_equal(got['s'].numpy(), np.asarray(want['s']),
                                  err_msg=prefix + 's')


def test_ddim_step_matches_jax():
    from ab_opt_tpu.diffusion import PositionTransition as JPos
    from ab_opt_tpu_torch.diffusion import PositionTransition
    j, t = JPos.create(100), PositionTransition(100)
    rng = np.random.default_rng(0)
    p_t, eps = (rng.normal(size=(3, 10, 3)).astype(np.float32)
                for _ in range(2))
    mask = np.zeros((3, 10), bool)
    mask[:, 2:7] = True
    for step, step_next in ((100, 95), (40, 35), (3, 0), (1, 0)):
        want = j.ddim_step(jnp.asarray(p_t), jnp.asarray(eps),
                           jnp.asarray(mask), jnp.asarray(step),
                           jnp.asarray(step_next))
        got = t.ddim_step(tt(p_t), tt(eps), tt(mask), step, step_next)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)
        np.testing.assert_array_equal(got.numpy()[~mask], p_t[~mask])


@pytest.mark.parametrize('stride', [2, 3])
def test_strided_sample_matches_jax(models, stride):
    """4 steps: stride 2 jumps 4 -> 2 -> 0; stride 3 jumps 4 -> 1 -> 0 (a
    shorter last jump). The first jump starts at t = T, where sqrt(1 /
    alpha_bar_T) = 2.3e7: DDIM rebuilds p_0 from the predicted noise
    (transitions.py:117-120) by multiplying it back by that factor, so in
    float32 that jump's generated positions carry an error of about
    2.3e7 |p| 2^-24 in either package, and no two implementations agree on
    them. That jump is held on its rotations, codes and context; every
    later jump, restarted from JAX's state with the same draws, on
    positions, rotations and codes."""
    reps = 2
    jmodel, params, jbatch, tmodel, tbatch = models
    key = jax.random.key(3)
    want = jmodel.sample(params, jbatch, key, num_replicas=reps,
                         keep_traj=True, stride=stride)['traj']
    ts = list(range(STEPS, 0, -stride))
    draws = _jax_draws(key, reps, L, len(ts))
    gablock.reset_counts()
    got = tmodel.sample(tbatch, num_replicas=reps, stride=stride,
                        keep_traj=True, draws=draws)['traj']
    assert gablock.gablock_layer_reference.calls == len(ts) * LAYERS
    assert got['p'].shape[0] == len(want['p']) == len(ts)
    gen = tbatch['generate_flag'].repeat_interleave(reps, 0)
    np.testing.assert_allclose(t_rot(got['v'][0]).numpy(),
                               np.asarray(j_rot(want['v'][0])), atol=1e-3,
                               rtol=0)
    np.testing.assert_array_equal(got['s'][0].numpy(), np.asarray(want['s'][0]))
    np.testing.assert_allclose(got['p'][0][~gen].numpy(),
                               np.asarray(want['p'][0])[~gen.numpy()],
                               atol=1e-5, rtol=0)
    assert torch.isfinite(got['p'][0]).all()

    rep = lambda a: a.repeat_interleave(reps, 0)
    with torch.no_grad():
        res_feat, pair_feat, _, _ = tmodel.encode(tbatch, True, True)
        mres = rep(tbatch['mask'])
        denoiser = tmodel.prepare_denoiser(pair_feat, mres, reps)
        for i in range(1, len(ts)):
            prev = {k: tt(v[i - 1]) for k, v in want.items()}
            v, p, s, _, _ = tmodel.reverse_step(
                prev['v'], tmodel.normalize_position(prev['p']),
                prev['s'].long(), ts[i], rep(res_feat), pair_feat, gen, mres,
                denoiser, reps, draws['steps'][i],
                t_next=max(ts[i] - stride, 0))
            _assert_states({'v': v, 'p': tmodel.unnormalize_position(p),
                            's': s}, {k: x[i] for k, x in want.items()},
                           f'step {i}: ')


def _optimize_draws(key, N, n_steps):
    """JAX DiffAb.optimize's draws (diffab.py:513): the rotation, position
    and sequence noising from k_rot, k_pos, k_seq; the loop from k_scan, as
    in DiffAb.sample (the fourth split there too)."""
    k_rot, k_pos, k_seq, _ = jax.random.split(key, 4)
    k_axis, k_angle = jax.random.split(k_rot)
    k_bin, k_frac, k_gauss = jax.random.split(k_angle, 3)
    return {'rot_axis': tt(jax.random.normal(k_axis, (N, L, 3))),
            'rot_u': tt(jax.random.uniform(k_bin, (N, L))),
            'rot_frac': tt(jax.random.uniform(k_frac, (N, L))),
            'rot_gauss': tt(jax.random.normal(k_gauss, (N, L))),
            'pos': tt(jax.random.normal(k_pos, (N, L, 3))),
            'seq_gumbel': tt(jax.random.gumbel(k_seq, (N, L, 20))),
            'steps': _jax_draws(key, N, L, n_steps)['steps']}


@pytest.mark.parametrize('opt_step', [2, 3])
def test_optimize_matches_jax(models, opt_step):
    """Two trajectories of one complex (the batch replicated, as
    BatchedSampler does for the optimize path), step by step: the first
    state (the native state noised to opt_step, then one step) from the
    whole call, every later step of its trajectory restarted from JAX's
    state with the same draws."""
    from ab_opt_tpu.parallel.mesh import replicate_batch as j_replicate
    from ab_opt_tpu_torch.parallel import replicate_batch
    jmodel, params, jbatch, tmodel, tbatch = models
    key = jax.random.key(opt_step)
    want = jmodel.optimize(params, j_replicate(jbatch, 2), key,
                           opt_step=opt_step, keep_traj=True)['traj']
    draws = _optimize_draws(key, 2, opt_step)
    batch = replicate_batch(tbatch, 2)
    gablock.reset_counts()
    got = tmodel.optimize(batch, opt_step, keep_traj=True, draws=draws)
    assert gablock.gablock_layer_reference.calls == opt_step * LAYERS
    assert got['traj']['p'].shape == (opt_step, 2, L, 3)
    _assert_states({k: v[0] for k, v in got['traj'].items()},
                   {k: v[0] for k, v in want.items()}, 'step 0: ')
    assert all(torch.equal(got[k], got['traj'][k][-1]) for k in 'vps')

    with torch.no_grad():
        res_feat, pair_feat, _, _ = tmodel.encode(batch, True, True)
        denoiser = tmodel.prepare_denoiser(pair_feat, batch['mask'])
        for i in range(1, opt_step):
            prev = {k: tt(v[i - 1]) for k, v in want.items()}
            v, p, s, _, _ = tmodel.reverse_step(
                prev['v'], tmodel.normalize_position(prev['p']),
                prev['s'].long(), opt_step - i, res_feat, pair_feat,
                batch['generate_flag'], batch['mask'], denoiser,
                draws=draws['steps'][i])
            _assert_states({'v': v, 'p': tmodel.unnormalize_position(p),
                            's': s}, {k: x[i] for k, x in want.items()},
                           f'step {i}: ')


def test_pallas_route_sample_matches_jax(models):
    """ipa_impl='pallas': the port's eager encoder in its sampling form (K4's
    plain version on the CPU, no K1) against the JAX sampler with K4 in
    interpret mode."""
    from ab_opt_tpu.models import DiffAb as JDiffAb
    from ab_opt_tpu.models import DiffAbConfig as JConfig
    reps = 2
    _, params, jbatch, _, tbatch = models
    kw = dict(res_feat_dim=32, pair_feat_dim=16, num_layers=LAYERS,
              num_steps=STEPS, ipa_impl='pallas')
    jmodel = JDiffAb(JConfig(**kw))
    tmodel = DiffAb(DiffAbConfig(**kw))
    tmodel.load_state_dict(params_to_state_dict(params))
    key = jax.random.key(3)
    want = jmodel.sample(params, jbatch, key, num_replicas=reps)
    gablock.reset_counts()
    ia.reset_counts()
    got = tmodel.sample(tbatch, num_replicas=reps,
                        draws=_jax_draws(key, reps, L, STEPS))
    assert ia.ipa_attention_fwd_p2n_reference.calls == STEPS * LAYERS
    assert gablock.gablock_layer_reference.calls == 0
    assert ia.ipa_attention_fwd_reference.calls == 0
    _assert_states(got, want)


# ------------------------------------------------------------ the runner




@pytest.mark.parametrize('flags', [
    dict(opt_step=2), dict(opt_step=3, keep_traj=True), dict(stride=3),
    dict(sample_structure=False), dict(sample_sequence=False)])
def test_batched_sampler_paths(models, flags):
    """Shapes, finite values, context residues unchanged (atoms and codes),
    and where a flag freezes a modality, that modality unchanged."""
    from ab_opt_tpu_torch.geometry import (construct_3d_basis,
                                           rotation_to_so3vec)
    from ab_opt_tpu_torch.runners.design import BatchedSampler
    _, _, jbatch, model, _ = models
    batch = {k: np.array(v) for k, v in jbatch.items()}
    reps = 3
    out = BatchedSampler(model, device='cpu', **flags)(batch, seed=1,
                                                       num_replicas=reps)
    assert out['pos_atom_new'].shape == (reps, L, 15, 3)
    assert out['p'].shape == (reps, L, 3) and out['s'].shape == (reps, L)
    assert all(np.isfinite(out[k]).all()
               for k in ('p', 'v', 'pos_atom_new', 'prmsd', 'perplexity'))
    ctx = ~batch['generate_flag'][0]
    pos, aa = batch['pos_heavyatom'][0], batch['aa'][0]
    np.testing.assert_array_equal(out['pos_atom_new'][:, ctx],
                                  np.broadcast_to(pos[ctx], (reps,) + pos[ctx].shape))
    np.testing.assert_array_equal(out['s'][:, ctx],
                                  np.broadcast_to(aa[ctx], (reps, int(ctx.sum()))))
    if 'keep_traj' in flags:
        assert out['traj']['p'].shape == (flags['opt_step'], reps, L, 3)
        np.testing.assert_array_equal(out['traj']['s'][-1], out['s'])
    if not flags.get('sample_structure', True):
        # The native frames (CA, C, N) and CA positions, on every residue.
        ca = np.broadcast_to(pos[:, 1], (reps, L, 3))
        np.testing.assert_allclose(out['p'], ca, atol=1e-4, rtol=0)
        v = rotation_to_so3vec(construct_3d_basis(
            *(torch.from_numpy(pos[None, :, a]) for a in (1, 2, 0))))
        np.testing.assert_allclose(
            out['v'], np.broadcast_to(v.numpy(), (reps, L, 3)), atol=1e-6,
            rtol=0)
    if not flags.get('sample_sequence', True):
        np.testing.assert_array_equal(out['s'], np.broadcast_to(aa, (reps, L)))


def test_replicate_batch_matches_jax():
    from ab_opt_tpu.parallel.mesh import replicate_batch as j_replicate
    from ab_opt_tpu_torch.parallel import replicate_batch
    rng = np.random.default_rng(0)
    batch = {'aa': rng.integers(0, 20, (2, 5)).astype(np.int32),
             'pos': rng.normal(size=(2, 5, 3)).astype(np.float32),
             'flag': np.array(True), 'name': 'x'}
    want = j_replicate({k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                        for k, v in batch.items()}, 3)
    got = replicate_batch({k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                               else v) for k, v in batch.items()}, 3)
    assert sorted(got) == sorted(want)
    for k in ('aa', 'pos', 'flag'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got['name'] == 'x'


def test_ipa_impl_values():
    assert DiffAbConfig.from_dict({'ipa_impl': 'pallas'}).ipa_impl == 'pallas'
    for impl in ('auto', 'pallas_fused', 'pallas'):
        assert DiffAbConfig(ipa_impl=impl).ipa_impl == impl
    with pytest.raises(ValueError, match="'auto', 'pallas_fused', 'pallas'"):
        DiffAbConfig(ipa_impl='einsum')
