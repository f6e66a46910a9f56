"""The port's ``DiffGNN.sample`` and ``DiffGNN.optimize`` against the JAX
package's, on the CPU: reverse trajectories of a small graph model (hidden
16, edge 8, 2 layers, 6 steps) on two synthetic complexes, one of them
padded, every noise draw re-derived from JAX's key the way JAX splits it
(diff_gnn.py:313-317, 345, 394; igso3.py:113, 141) and fed to the port.

Cases: ``sample`` with ``num_replicas=2`` (the adjacency norm spans all
four trajectories), with ``stride=2`` (DDIM position steps), with
``sample_structure=False``, and ``optimize(opt_step=3)``, each jitted once
with ``keep_traj``. The whole trajectory: final positions within 1e-3,
codes exact, the context unchanged. Then every later step, restarted from
JAX's state with the same draws: positions and rotation matrices within
1e-3, codes exact. The whole trajectory is not held on rotations: jitted,
JAX's reverse loop moves one generated residue's rotation of the replicas
case by 0.03 at its first step against JAX's own op-by-op evaluation
(``jax.disable_jit``), which the port matches within 2e-4.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from test_torch_gnn import (KW, N, STEPS, _perturbed, gnn_batch,  # noqa: E402
                            port_batch, port_model, rot_draws)

L = 24
tt = lambda a: torch.from_numpy(np.array(a))


def _step_draws(key, n, steps):
    out = []
    for _ in range(steps):
        key, k_rd, k_pd = jax.random.split(key, 3)
        out.append(dict(rot_draws(k_rd, n, L),
                        pos=tt(jax.random.normal(k_pd, (n, L, 3)))))
    return out


def sample_draws(key, n, steps):
    """JAX DiffGNN.sample's draws for ``n`` trajectories."""
    k_v, k_p, k_scan = jax.random.split(key, 3)
    return {'init_quat': tt(jax.random.normal(k_v, (n, L, 4))),
            'init_pos': tt(jax.random.normal(k_p, (n, L, 3))),
            'steps': _step_draws(k_scan, n, steps)}


def optimize_draws(key, n, steps):
    """JAX DiffGNN.optimize's draws."""
    k_rot, k_pos, k_scan = jax.random.split(key, 3)
    return dict(rot_draws(k_rot, n, L),
                pos=tt(jax.random.normal(k_pos, (n, L, 3))),
                steps=_step_draws(k_scan, n, steps))


@pytest.fixture(scope='module')
def setup():
    from ab_opt_tpu.models import DiffGNN as JDiffGNN
    from ab_opt_tpu.models import DiffGNNConfig as JConfig
    jm = JDiffGNN(JConfig(**dict(KW, n_layers=2)))
    params = _perturbed(jax.jit(jm.init)(jax.random.key(0), gnn_batch()))
    batch = gnn_batch(seed=11, n_pad=5)
    return jm, params, batch, port_model(params, n_layers=2)


def _check(got, want, batch, reps, structure=True, whole=True):
    """Final positions within 1e-3 (``whole``), codes exact, the context
    unchanged and, with ``structure``, the generated positions moved."""
    if whole:
        np.testing.assert_allclose(got['p'].numpy(), np.asarray(want['p']),
                                   atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got['s'].numpy(), np.asarray(want['s']))
    rep = lambda a: np.repeat(a, reps, axis=0)
    ctx = ~rep(batch['generate_flag']) & rep(batch['mask'])
    np.testing.assert_array_equal(got['s'].numpy()[ctx], rep(batch['aa'])[ctx])
    native = rep(batch['pos_heavyatom'][:, :, 1])
    np.testing.assert_allclose(got['p'].numpy()[ctx], native[ctx], atol=1e-5)
    if structure:
        gen = rep(batch['generate_flag'])
        assert np.abs(got['p'].numpy()[gen] - native[gen]).max() > 0.1


def _restarted_steps(model, batch, want, ts, stride, draws, reps=1,
                     structure=True, sequence=True):
    """Every step i >= 1 of JAX's trajectory ``want`` (keep_traj),
    restarted from JAX's state after step i - 1 with step i's draws:
    positions and rotation matrices within 1e-3, codes exact."""
    from ab_opt_tpu.geometry import so3vec_to_rotation as j_rot
    from ab_opt_tpu_torch.geometry import so3vec_to_rotation as t_rot
    with torch.no_grad():
        prep = model._prepare(port_batch(batch), structure,
                              sequence).repeat(reps)
        for i in range(1, len(ts)):
            prev = {k: tt(v[i - 1]) for k, v in want.items()}
            v, p, s = model.reverse_step(
                prev['v'], model.normalize_position(prev['p']),
                prev['s'].long(), ts[i], prep, draws[i], None, structure,
                sequence, None if stride == 1 else max(ts[i] - stride, 0))
            np.testing.assert_allclose(
                model.unnormalize_position(p).numpy(),
                np.asarray(want['p'][i]), atol=1e-3, rtol=0,
                err_msg=f'step {i}')
            np.testing.assert_allclose(
                t_rot(v).numpy(), np.asarray(j_rot(want['v'][i])), atol=1e-3,
                rtol=0, err_msg=f'step {i}')
            np.testing.assert_array_equal(s.numpy(), np.asarray(want['s'][i]))


@pytest.mark.parametrize('case', ['replicas', 'stride', 'frozen_structure'])
def test_sample_matches_jax(setup, case):
    """The whole trajectory, then each later step restarted from JAX's
    state. A strided sample's first jump starts at t = T, where DDIM
    rebuilds p_0 from the predicted noise by multiplying it back by
    sqrt(1 / alpha_bar_T - 1) = 2.3e7: in float32 its generated positions
    carry an error of about 2.3e7 |p| 2^-24 in either package, so that jump
    is held on its codes and context (as DiffAb's strided test holds it)."""
    jm, params, batch, model = setup
    kw = {'replicas': dict(num_replicas=2),
          'stride': dict(stride=2),
          'frozen_structure': dict(sample_structure=False)}[case]
    reps, stride = kw.get('num_replicas', 1), kw.get('stride', 1)
    structure = kw.get('sample_structure', True)
    ts = list(range(STEPS, 0, -stride))
    key = jax.random.key(3)
    want = jax.jit(lambda p, b, k: jm.sample(p, b, k, keep_traj=True, **kw))(
        params, batch, key)
    draws = sample_draws(key, N * reps, len(ts))
    got = model.sample(port_batch(batch), draws=draws, keep_traj=True, **kw)
    assert sorted(got['traj']) == sorted(want['traj'])
    assert got['traj']['p'].shape[0] == len(ts)
    _check(got, want, batch, reps, structure, whole=stride == 1)
    _restarted_steps(model, batch, want['traj'], ts, stride, draws['steps'],
                     reps, structure)


def test_optimize_matches_jax(setup):
    jm, params, batch, model = setup
    key, opt_step = jax.random.key(5), 3
    want = jax.jit(lambda p, b, k: jm.optimize(p, b, k, opt_step,
                                               keep_traj=True))(
        params, batch, key)
    draws = optimize_draws(key, N, opt_step)
    got = model.optimize(port_batch(batch), opt_step, draws=draws,
                         keep_traj=True)
    _check(got, want, batch, 1)
    _restarted_steps(model, batch, want['traj'], list(range(opt_step, 0, -1)),
                     1, draws['steps'])
