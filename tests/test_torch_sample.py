"""The slice as a whole: the port's DiffAb.sample against the JAX
DiffAb.sample (ipa_impl='einsum'), float32, num_replicas=2, L=24, 2 layers,
4 steps, whole trajectories and step by step. The port runs its sampler
path (the GABlock layer's plain version on CPU) and consumes JAX's draws,
re-derived from the same key the way DiffAb.sample / _reverse_scan split it
(diffab.py:388,474). Positions and rotation matrices at atol 1e-3,
sequences exact."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from test_torch_model import small_models  # noqa: E402


def _jax_draws(key, N, L, num_steps):
    k_init_v, k_init_p, k_init_s, key = jax.random.split(key, 4)
    draws = {'init_quat': jax.random.normal(k_init_v, (N, L, 4)),
             'init_pos': jax.random.normal(k_init_p, (N, L, 3)),
             'init_seq': jax.random.randint(k_init_s, (N, L), 0, 19,
                                            jnp.int32),
             'steps': []}
    for _ in range(num_steps):
        key, k_rot, k_pos, k_seq = jax.random.split(key, 4)
        k_axis, k_angle = jax.random.split(k_rot)
        k_bin, k_frac, k_gauss = jax.random.split(k_angle, 3)
        draws['steps'].append({
            'rot_axis': jax.random.normal(k_axis, (N, L, 3)),
            'rot_u': jax.random.uniform(k_bin, (N, L)),
            'rot_frac': jax.random.uniform(k_frac, (N, L)),
            'rot_gauss': jax.random.normal(k_gauss, (N, L)),
            'pos': jax.random.normal(k_pos, (N, L, 3)),
            'seq_gumbel': jax.random.gumbel(k_seq, (N, L, 20), jnp.float32)})
    tt = lambda a: torch.from_numpy(np.array(a))
    draws['steps'] = [{k: tt(v) for k, v in s.items()} for s in draws['steps']]
    return {k: (v if k == 'steps' else tt(v)) for k, v in draws.items()}


def test_sample_matches_jax():
    """Whole trajectories from the same draws. The reference's log map
    clamps cos(theta) at -0.9999, so a rotation whose angle crosses that
    point jumps, and float32 rounding differences on such a trajectory grow
    ~10x per step; this case (flax's own init, key 3) stays clear of it.
    test_reverse_steps_match_jax holds every step without that caveat."""
    from ab_opt_tpu.geometry import so3vec_to_rotation as j_rot
    from ab_opt_tpu_torch.geometry import so3vec_to_rotation as t_rot
    from ab_opt_tpu_torch.ops import gablock
    reps, steps, L = 2, 4, 24
    jmodel, params, jbatch, tmodel, tbatch = small_models(
        L=L, num_layers=2, num_steps=steps, noise=0.0)
    key = jax.random.key(3)
    want = jmodel.sample(params, jbatch, key, num_replicas=reps)
    gablock.reset_counts()
    got = tmodel.sample(tbatch, num_replicas=reps,
                        draws=_jax_draws(key, reps, L, steps))
    assert gablock.gablock_layer_reference.calls == steps * 2
    np.testing.assert_allclose(got['p'].numpy(), np.asarray(want['p']),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(t_rot(got['v']).numpy(),
                               np.asarray(j_rot(want['v'])), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got['s'].numpy(), np.asarray(want['s']))
    np.testing.assert_allclose(got['prmsd'].numpy(), np.asarray(want['prmsd']),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got['perplexity'].numpy(),
                               np.asarray(want['perplexity']), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize('seed', [3, 8])
def test_reverse_steps_match_jax(seed):
    """Every reverse step of the JAX trajectory (keep_traj), restarted from
    JAX's own state: port step t -> t-1 against JAX's next state, same
    draws. Positions (A) and rotation matrices at atol 1e-3, codes exact."""
    from ab_opt_tpu.geometry import so3vec_to_rotation as j_rot
    from ab_opt_tpu_torch.geometry import so3vec_to_rotation as t_rot
    reps, steps, L = 2, 4, 24
    jmodel, params, jbatch, tmodel, tbatch = small_models(
        L=L, num_layers=2, num_steps=steps)
    key = jax.random.key(seed)
    traj = jmodel.sample(params, jbatch, key, num_replicas=reps,
                         keep_traj=True)['traj']
    draws = _jax_draws(key, reps, L, steps)['steps']
    rep = lambda a: a.repeat_interleave(reps, 0)
    with torch.no_grad():
        res_feat, pair_feat, _, _ = tmodel.encode(tbatch, True, True)
        gen, mres = rep(tbatch['generate_flag']), rep(tbatch['mask'])
        denoiser = tmodel.prepare_denoiser(pair_feat, mres, reps)
        for i in range(1, steps):
            tt = lambda a: torch.from_numpy(np.array(a[i - 1]))
            v, p, s, _, _ = tmodel.reverse_step(
                tt(traj['v']), tmodel.normalize_position(tt(traj['p'])),
                tt(traj['s']).long(), steps - i, rep(res_feat), pair_feat,
                gen, mres, denoiser, reps, draws[i])
            np.testing.assert_allclose(
                tmodel.unnormalize_position(p).numpy(),
                np.asarray(traj['p'][i]), atol=1e-3, rtol=0)
            np.testing.assert_allclose(t_rot(v).numpy(),
                                       np.asarray(j_rot(traj['v'][i])),
                                       atol=1e-3, rtol=0)
            np.testing.assert_array_equal(s.numpy(), np.asarray(traj['s'][i]))


def test_batched_sampler_keeps_context():
    """BatchedSampler on CPU (asked for explicitly): finite outputs of the
    fan-out shape, context residues (atoms and codes) unchanged."""
    from ab_opt_tpu_torch.runners.design import BatchedSampler
    _, _, jbatch, tmodel, tbatch = small_models(L=24, num_layers=1,
                                                num_steps=3)
    sampler = BatchedSampler(tmodel, device='cpu')
    out = sampler({k: np.array(v) for k, v in jbatch.items()}, seed=0,
                  num_replicas=3)
    assert out['pos_atom_new'].shape == (3, 24, 15, 3)
    assert all(np.isfinite(out[k]).all() for k in ('p', 'v', 'pos_atom_new'))
    ctx = ~np.asarray(jbatch['generate_flag'])[0]
    pos = np.asarray(jbatch['pos_heavyatom'])[0]
    np.testing.assert_array_equal(out['pos_atom_new'][:, ctx],
                                  np.broadcast_to(pos[ctx], (3,) + pos[ctx].shape))
    np.testing.assert_array_equal(out['s'][:, ctx],
                                  np.broadcast_to(np.asarray(jbatch['aa'])[0][ctx],
                                                  (3, int(ctx.sum()))))
