"""The training slice of the port (forward noising, losses, DiffAb.loss,
the trainer and checkpoints) against the JAX package, on the CPU.

Every draw JAX makes is re-derived from its key the way the JAX function
splits it (diffab.py:191,208; igso3.py:113,141; transitions.py:73,218) and
fed to the port:

* ``add_noise`` of the three transitions and per-element IGSO3 sampling:
  rotations and positions at 1e-5, codes exact, the forward IGSO3 tables at
  1e-6;
* every loss function at 1e-5;
* ``DiffAb.loss`` and its parameter gradients against JAX ``DiffAb.loss``
  with ``ipa_impl='pallas'`` (interpret mode) through
  ``params_to_state_dict``: losses rtol 1e-4, gradients 2e-4 x the tensor's
  max;
* one ``Trainer.train_step`` against the step of JAX ``sharded_train_step``
  (weighted total, clip 100, optax Adam) applied to the same JAX loss and
  gradients: updated parameters within 1e-6 where |g| > 1e-5 and within
  2 lr elsewhere (Adam's first step is sign-like);
* the schedulers, the finite-loss guard, the checkpoint round trip and the
  entry points' default device.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from ab_opt_tpu import diffusion as JD  # noqa: E402
from ab_opt_tpu.geometry import so3vec_to_rotation as j_rot  # noqa: E402
from ab_opt_tpu.models import losses as JL  # noqa: E402
from ab_opt_tpu_torch import diffusion as TD  # noqa: E402
from ab_opt_tpu_torch.data.collate import to_device_batch  # noqa: E402
from ab_opt_tpu_torch.geometry import so3vec_to_rotation as t_rot  # noqa: E402
from ab_opt_tpu_torch.models import DiffAb, DiffAbConfig  # noqa: E402
from ab_opt_tpu_torch.models import losses as TL  # noqa: E402
from ab_opt_tpu_torch.ops import ipa_attention as ia  # noqa: E402
from ab_opt_tpu_torch.train import Trainer  # noqa: E402
from ab_opt_tpu_torch.utils.convert import params_to_state_dict  # noqa: E402

STEPS = 100
N, L = 3, 10
WEIGHTS = {'rot': 1.0, 'pos': 1.0, 'seq': 1.0, 'dist': 1.0, 'prmsd': 0.1}
tt = lambda a: torch.from_numpy(np.array(a))


@pytest.fixture(scope='module')
def transitions():
    return {
        'rot': (JD.RotationTransition.create(STEPS), TD.RotationTransition(STEPS)),
        'pos': (JD.PositionTransition.create(STEPS), TD.PositionTransition(STEPS)),
        'seq': (JD.SequenceTransition.create(STEPS), TD.SequenceTransition(STEPS)),
    }


def _mask():
    m = np.zeros((N, L), bool)
    m[:, 3:7] = True
    return m


def _levels(per_residue, seed=0):
    rng = np.random.default_rng(seed)
    if per_residue:
        return rng.integers(0, STEPS, (N, L)).astype(np.int32)
    return np.asarray([1, 40, 99], np.int32)     # both IGSO3 branches


def _igso3_draws(key, shape):
    k_axis, k_angle = jax.random.split(key)
    k_bin, k_frac, k_gauss = jax.random.split(k_angle, 3)
    return {'axis': tt(jax.random.normal(k_axis, shape + (3,))),
            'u': tt(jax.random.uniform(k_bin, shape)),
            'frac': tt(jax.random.uniform(k_frac, shape)),
            'gauss': tt(jax.random.normal(k_gauss, shape))}


def test_igso3_forward_tables(transitions):
    j, t = transitions['rot']
    np.testing.assert_allclose(t.igso3_fwd.cdf.numpy(),
                               np.asarray(j.igso3_fwd.cdf), atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.igso3_fwd.stddevs,
                               np.asarray(j.igso3_fwd.stddevs), atol=1e-6)
    np.testing.assert_array_equal(t.igso3_fwd.approx_flag,
                                  np.asarray(j.igso3_fwd.approx_flag))


@pytest.mark.parametrize('per_residue', [False, True])
def test_igso3_per_element_angles_match_jax(transitions, per_residue):
    from ab_opt_tpu.diffusion.igso3 import sample_igso3_angle as j_angle
    from ab_opt_tpu_torch.diffusion.igso3 import sample_igso3_angle
    j, t = transitions['rot']
    lv = _levels(per_residue, seed=1)
    lv_full = lv if per_residue else np.repeat(lv[:, None], L, 1)
    key = jax.random.key(3)
    want = j_angle(key, j.igso3_fwd, jnp.asarray(lv_full), (N, L))
    k_bin, k_frac, k_gauss = jax.random.split(key, 3)
    got = sample_igso3_angle(
        t.igso3_fwd, tt(lv), (N, L), u=tt(jax.random.uniform(k_bin, (N, L))),
        frac=tt(jax.random.uniform(k_frac, (N, L))),
        gauss=tt(jax.random.normal(k_gauss, (N, L))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize('per_residue', [False, True])
def test_rotation_add_noise_matches_jax(transitions, per_residue):
    j, t = transitions['rot']
    v0 = (np.random.default_rng(2).normal(size=(N, L, 3)) * 0.8).astype(np.float32)
    lv, mask = _levels(per_residue), _mask()
    key = jax.random.key(5)
    want_v, want_e = j.add_noise(key, jnp.asarray(v0), jnp.asarray(mask),
                                 jnp.asarray(lv))
    got_v, got_e = t.add_noise(tt(v0), tt(mask), tt(lv),
                               **_igso3_draws(key, (N, L)))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(t_rot(got_v).numpy(), np.asarray(j_rot(want_v)),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_v[~tt(mask)].numpy(), v0[~mask])


@pytest.mark.parametrize('per_residue', [False, True])
def test_position_add_noise_matches_jax(transitions, per_residue):
    j, t = transitions['pos']
    p0 = np.random.default_rng(3).normal(size=(N, L, 3)).astype(np.float32)
    lv, mask = _levels(per_residue), _mask()
    key = jax.random.key(6)
    want, want_eps = j.add_noise(key, jnp.asarray(p0), jnp.asarray(mask),
                                 jnp.asarray(lv))
    got, got_eps = t.add_noise(tt(p0), tt(mask), tt(lv),
                               eps=tt(jax.random.normal(key, (N, L, 3))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_eps.numpy(), np.asarray(want_eps))
    p_start = t.pred_start_from_noise(got, got_eps, tt(mask), tt(lv))
    want_start = j.pred_start_from_noise(want, want_eps, jnp.asarray(mask),
                                         jnp.asarray(lv))
    np.testing.assert_allclose(p_start.numpy(), np.asarray(want_start),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize('per_residue', [False, True])
def test_sequence_add_noise_and_posterior_match_jax(transitions, per_residue):
    j, t = transitions['seq']
    rng = np.random.default_rng(4)
    x0 = rng.integers(0, 20, (N, L)).astype(np.int32)
    lv, mask = _levels(per_residue), _mask()
    key = jax.random.key(7)
    want_c, want_x = j.add_noise(key, jnp.asarray(x0), jnp.asarray(mask),
                                 jnp.asarray(lv))
    got_c, got_x = t.add_noise(tt(x0).long(), tt(mask), tt(lv),
                               gumbel=tt(jax.random.gumbel(key, (N, L, 20))))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    probs = rng.dirichlet(np.ones(20), (N, L)).astype(np.float32)
    for x_0 in (x0, probs):
        want = j.posterior(want_x, jnp.asarray(x_0), jnp.asarray(lv))
        got = t.posterior(got_x, tt(x_0).long() if x_0 is x0 else tt(x_0),
                          tt(lv))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


# ------------------------------------------------------------ losses


def _loss_inputs():
    rng = np.random.default_rng(8)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q = f(N, L, 4)
    from ab_opt_tpu.geometry import quaternion_to_rotation_matrix
    R1 = np.array(quaternion_to_rotation_matrix(jnp.asarray(q)))
    R2 = np.array(quaternion_to_rotation_matrix(jnp.asarray(q + 0.3 * f(N, L, 4))))
    post = rng.dirichlet(np.ones(20), (N, L)).astype(np.float32)
    post[0, 3, :5] = 0.0                          # 0 log 0 = 0
    mres = np.ones((N, L), bool)
    mres[:, -2:] = False
    return dict(R1=R1, R2=R2, p1=f(N, L, 3), p2=f(N, L, 3) * 2,
                x=f(N, L), post=post, logq=np.log(rng.dirichlet(
                    np.ones(20), (N, L)).astype(np.float32)),
                mgen=_mask(), mres=mres, logits=f(N, 40),
                rmsd=np.abs(f(N)) * 6, mc=np.array([True, False, True]))


LOSSES = {
    'masked_mean': lambda M, c: M.masked_mean(c['x'], c['mgen']),
    'rotation_matrix_cosine_loss':
        lambda M, c: M.rotation_matrix_cosine_loss(c['R1'], c['R2']),
    'smooth_l1': lambda M, c: M.smooth_l1(c['p1'], c['p2']),
    'pairwise_distance_loss':
        lambda M, c: M.pairwise_distance_loss(c['p1'], c['p2'], c['mgen'],
                                              c['mres']),
    'sequence_kl_loss':
        lambda M, c: M.sequence_kl_loss(c['post'], c['logq'], c['mgen']),
    'masked_rmsd': lambda M, c: M.masked_rmsd(c['p1'], c['p2'], c['mgen']),
    'prmsd_loss': lambda M, c: M.prmsd_loss(c['logits'], c['rmsd'], c['mc'],
                                            0.5, 19.5, 40),
}


@pytest.mark.parametrize('name', sorted(LOSSES))
def test_loss_function_matches_jax(name):
    c = _loss_inputs()
    want = LOSSES[name](JL, {k: jnp.asarray(v) for k, v in c.items()})
    got = LOSSES[name](TL, {k: tt(v) for k, v in c.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_distance_to_bins_onehot_matches_jax():
    from ab_opt_tpu.nn.layers import distance_to_bins_onehot as j_bins
    from ab_opt_tpu_torch.nn.layers import distance_to_bins_onehot
    d = np.random.default_rng(9).uniform(0, 25, (64,)).astype(np.float32)
    np.testing.assert_array_equal(distance_to_bins_onehot(tt(d), 0.5, 19.5, 40),
                                  np.asarray(j_bins(jnp.asarray(d), 0.5, 19.5, 40)))


# ------------------------------------------------------------ DiffAb.loss


def _loss_draws(key, N, L, num_steps, mask_ratio=None):
    """JAX DiffAb.loss's draws (and t) from its key; with ``mask_ratio``
    (min, max) also its partial-CDR mask (diffab.py:191-199)."""
    key, k_mask = jax.random.split(key)
    k_t, k_rot, k_pos, k_seq = jax.random.split(key, 4)
    draws = {('rot_' + k): v for k, v in _igso3_draws(k_rot, (N, L)).items()}
    draws['pos'] = tt(jax.random.normal(k_pos, (N, L, 3)))
    draws['seq_gumbel'] = tt(jax.random.gumbel(k_seq, (N, L, 20)))
    if mask_ratio is not None:
        ratio = jax.random.uniform(k_mask, (), minval=mask_ratio[0],
                                   maxval=mask_ratio[1])
        draws['mask_keep'] = tt(jax.random.bernoulli(
            jax.random.fold_in(k_mask, 1), ratio, (N, L)))
    return tt(jax.random.randint(k_t, (N,), 0, num_steps)), draws


@pytest.fixture(scope='module')
def slice_models():
    """A JAX DiffAb (pallas IPA, interpret mode, float32) with perturbed
    random params, the port DiffAb carrying the same weights, and a batch of
    three synthetic complexes."""
    from ab_opt_tpu.models import DiffAb as JDiffAb
    from ab_opt_tpu.models import DiffAbConfig as JConfig
    from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch
    kw = dict(res_feat_dim=32, pair_feat_dim=16, num_layers=2, num_steps=10)
    jmodel = JDiffAb(JConfig(ipa_impl='pallas', **kw))
    # The port's synthetic complex (held equal to the JAX package's by
    # tests/test_torch_model.py), as numpy.
    jbatch = {k: v.numpy() for k, v in synthetic_batch(
        np.random.default_rng(0), N=3, L=24, n_ab=16, gen_lo=6,
        gen_hi=12).items()}
    # The einsum model has the same parameter tree and initializes faster.
    params = jax.jit(JDiffAb(JConfig(ipa_impl='einsum', **kw)).init)(
        jax.random.key(0), jbatch)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), params)
    return jmodel, params, jbatch, kw


def _port_model(params, kw):
    model = DiffAb(DiffAbConfig(**kw))
    model.load_state_dict(params_to_state_dict(params))
    return model


LOSS_KEY, LOSS_T = 11, np.asarray([0, 4, 9], np.int32)


@pytest.fixture(scope='module')
def jax_loss_and_grads(slice_models):
    """JAX ``DiffAb.loss`` (Pallas IPA) at key LOSS_KEY and t LOSS_T, and
    the gradients of its weighted total: jitted once, shared by the loss
    and train-step tests. Returns (total, losses, grads)."""
    jmodel, params, jbatch, _ = slice_models

    def total(p):
        losses = jmodel.loss(p, jbatch, jax.random.key(LOSS_KEY),
                             t=jnp.asarray(LOSS_T))
        return sum(losses[k] * WEIGHTS[k] for k in losses), losses

    (tot, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        params)
    return tot, losses, grads


def test_diffab_loss_and_grads_match_jax(slice_models, jax_loss_and_grads):
    _, params, jbatch, kw = slice_models
    _, want, grads = jax_loss_and_grads
    key, t = jax.random.key(LOSS_KEY), LOSS_T
    want_g = params_to_state_dict(grads)

    model = _port_model(params, kw)
    batch = to_device_batch(jbatch)
    ia.reset_counts()
    got = model.loss(batch, t=tt(t), draws=_loss_draws(key, 3, 24, 10)[1])
    sum(got[k] * WEIGHTS[k] for k in got).backward()
    assert ia.ipa_attention_fwd_reference.calls == kw['num_layers']
    assert ia.ipa_attention_bwd_reference.calls == kw['num_layers']
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want_g)
    for name, w in want_g.items():
        w = w.numpy()
        tol = 2e-4 * max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(named[name].grad.numpy(), w, atol=tol,
                                   rtol=0, err_msg=name)


def test_diffab_loss_variant_matches_jax(slice_models):
    """The branches the default config skips: ``obj='pred_noise'``, random
    partial-CDR masking and a structure-only step; losses against JAX's on
    the same draws."""
    from ab_opt_tpu.models import DiffAb as JDiffAb
    from ab_opt_tpu.models import DiffAbConfig as JConfig
    _, params, jbatch, kw = slice_models
    var = dict(kw, obj='pred_noise', mask_ratio_min=0.3, mask_ratio_max=1.0,
               train_sequence=False)
    jmodel = JDiffAb(JConfig(ipa_impl='pallas', **var))
    key, t = jax.random.key(13), np.asarray([2, 5, 8], np.int32)
    want = jax.jit(lambda p: jmodel.loss(p, jbatch, key,
                                         t=jnp.asarray(t)))(params)
    draws = _loss_draws(key, 3, 24, 10, mask_ratio=(0.3, 1.0))[1]
    keep = draws['mask_keep'] & tt(jbatch['generate_flag'])
    assert 0 < int(keep.sum()) < int(tt(jbatch['generate_flag']).sum())
    got = _port_model(params, var).loss(to_device_batch(jbatch), t=tt(t),
                                        draws=draws)
    assert sorted(got) == sorted(want) == ['pos', 'prmsd', 'rot', 'seq']
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_train_step_matches_jax(slice_models, jax_loss_and_grads):
    """JAX's train step (``parallel/mesh.py::sharded_train_step``: the
    weighted total, the clip to a global norm, optax Adam) applied to the
    shared JAX loss and gradients, against one ``Trainer.train_step`` on
    the same draws."""
    import optax
    _, params, jbatch, kw = slice_models
    total, want, grads = jax_loss_and_grads
    want = dict(want, overall=total)
    lr, key = 1e-4, jax.random.key(LOSS_KEY)
    opt = optax.adam(lr)

    @jax.jit
    def step(params, grads):
        scale = jnp.minimum(1.0, 100.0 / (optax.global_norm(grads) + 1e-6))
        grads = jax.tree_util.tree_map(lambda g: g * scale, grads)
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates)

    want_sd = params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, step(params, grads)))

    trainer = Trainer(_port_model(params, kw),
                      {'loss_weights': WEIGHTS, 'max_grad_norm': 100.0,
                       'optimizer': {'type': 'adam', 'lr': lr}}, device='cpu')
    got = trainer.train_step(jbatch, t=tt(LOSS_T),
                             draws=_loss_draws(key, 3, 24, 10)[1])
    assert trainer.iteration == 1
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    for name, p in trainer.model.named_parameters():
        delta = np.abs(p.detach().numpy() - want_sd[name].numpy())
        big = np.abs(p.grad.numpy()) > 1e-5
        assert delta[big].max(initial=0.0) <= 1e-6, name
        assert delta.max() <= 2 * lr, name


def test_diffab_config_from_dict_matches_jax():
    from ab_opt_tpu.models import DiffAbConfig as JConfig
    section = {'type': 'diffab', 'res_feat_dim': 128, 'pair_feat_dim': 64,
               'diffusion': {'num_steps': 100, 'eps_net_opt': {'num_layers': 4},
                             'obj': 'pred_noise',
                             'position_scale': [10.0]},
               'train_structure': True, 'train_sequence': False,
               'mask_ratio_min': 0.2, 'mask_ratio_max': 0.6,
               'resolution': 'backbone+CB', 'seed': 3}
    got = dataclasses.asdict(DiffAbConfig.from_dict(section))
    want = dataclasses.asdict(JConfig.from_dict(section))
    assert got == {k: v for k, v in want.items() if k in got}
    assert got['num_layers'] == 4 and got['num_atoms'] == 5


# ------------------------------------------------------------ the trainer


def _tiny(seed=0):
    from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch
    torch.manual_seed(seed)
    cfg = DiffAbConfig(res_feat_dim=16, pair_feat_dim=8, num_layers=1,
                       num_steps=5)
    batch = synthetic_batch(np.random.default_rng(seed), N=2, L=16, n_ab=10,
                            gen_lo=4, gen_hi=8)
    return DiffAb(cfg), batch


TRAIN_CFG = {'loss_weights': WEIGHTS, 'max_grad_norm': 100.0,
             'optimizer': {'type': 'adam', 'lr': 1e-3}, 'val_freq': 2,
             'scheduler': {'type': 'plateau', 'factor': 0.5, 'patience': 0,
                           'min_lr': 1e-4}}


@pytest.mark.parametrize('kind,opts', [
    ('plateau', {'factor': 0.5, 'patience': 1, 'min_lr': 1e-3}),
    ('exp', {'factor': 0.9, 'min_lr': 5e-3})])
def test_schedulers_match_jax(kind, opts):
    from ab_opt_tpu.train.trainer import build_scheduler as j_build
    from ab_opt_tpu_torch.train import build_scheduler
    got, want = (build(dict(opts, type=kind)) for build in (build_scheduler,
                                                            j_build))
    lr_g = lr_w = 1e-2
    for metric in (5.0, 4.0, 4.5, 4.2, 4.1, 3.0, 3.5, 3.6, 3.7, 3.8):
        lr_g, lr_w = got.step(metric, lr_g), want.step(metric, lr_w)
        assert lr_g == lr_w
    assert lr_g < 1e-2
    assert build_scheduler(None) is None


def test_train_step_clips_to_the_global_norm():
    """Gradients are scaled by min(1, max / (global norm + 1e-6)), as the
    JAX train step (parallel/mesh.py:91-94) does."""
    model, batch = _tiny()
    trainer = Trainer(model, dict(TRAIN_CFG, max_grad_norm=0.05),
                      device='cpu')
    t = torch.tensor([1, 3])
    trainer.loss_and_grads(to_device_batch(batch), t=t,
                           generator=torch.Generator().manual_seed(0))
    params = [p for p in model.parameters() if p.grad is not None]
    raw = [p.grad.clone() for p in params]
    norm = float(torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in raw])))
    assert norm > 0.05
    trainer.optimizer.step = lambda: None          # keep the weights
    trainer.train_step(batch, t=t, generator=torch.Generator().manual_seed(0))
    for p, g in zip(params, raw):
        torch.testing.assert_close(p.grad, g * (0.05 / (norm + 1e-6)),
                                   atol=1e-7, rtol=1e-5)


def test_nan_guard_dumps_the_batch_and_raises(tmp_path):
    import pickle
    model, batch = _tiny()
    trainer = Trainer(model, TRAIN_CFG, log_dir=str(tmp_path), device='cpu')
    real_loss = model.loss

    def nan_loss(*a, **k):
        losses = real_loss(*a, **k)
        return dict(losses, rot=losses['rot'] * float('nan'))

    model.loss = nan_loss
    with pytest.raises(FloatingPointError, match='Non-finite loss at it 0'):
        trainer.train_step(batch)
    with open(tmp_path / 'nan_dump_it0.pkl', 'rb') as f:
        dump = pickle.load(f)
    np.testing.assert_array_equal(dump['batch']['aa'], batch['aa'].numpy())
    assert np.isnan(dump['losses']['rot'])


def test_checkpoint_round_trip_and_resume(tmp_path):
    model, batch = _tiny()
    t, gen = torch.tensor([1, 3]), torch.Generator().manual_seed(0)
    trainer = Trainer(model, TRAIN_CFG, log_dir=str(tmp_path),
                      full_config={'model': dataclasses.asdict(model.cfg)},
                      device='cpu')
    trainer.train_step(batch, generator=gen, t=t)
    trainer._set_lr(5e-4)
    path = trainer.save(extra={'note': 'x'})
    assert path.endswith('1.ckpt')

    from ab_opt_tpu_torch.train import load_checkpoint
    saved = load_checkpoint(path)
    assert saved['iteration'] == 1 and saved['extra'] == {'note': 'x', 'lr': 5e-4}
    assert DiffAbConfig(**saved['config']['model']) == model.cfg

    fresh = Trainer(_tiny(seed=1)[0], TRAIN_CFG, device='cpu')
    fresh.resume(path)
    assert fresh.iteration == 1 and fresh.lr == 5e-4
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=k)
    # Both continue identically: the optimizer state came back too.
    for tr in (trainer, fresh):
        tr.train_step(batch, generator=torch.Generator().manual_seed(1), t=t)
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=k)

    finetune = Trainer(_tiny(seed=2)[0], TRAIN_CFG, device='cpu')
    finetune.resume(path, finetune=True)
    assert finetune.iteration == 0 and finetune.lr == 1e-3


def test_train_loop_validates_and_saves(tmp_path):
    model, batch = _tiny()
    trainer = Trainer(model, TRAIN_CFG, log_dir=str(tmp_path), device='cpu')
    seen, step = [], trainer.train_step

    def recording_step(*a, **k):
        losses = step(*a, **k)
        seen.append((trainer.iteration, float(losses['overall'])))
        return losses

    trainer.train_step = recording_step
    trainer.train(iter([batch] * 4), val_loader=[batch], max_iters=4,
                  log_every=2)
    assert [it for it, _ in seen] == [1, 2, 3, 4]
    assert all(np.isfinite(v) for _, v in seen)
    assert sorted(p.name for p in (tmp_path / 'checkpoints').iterdir()) == [
        '2.ckpt', '4.ckpt']


def test_entry_points_run_on_the_card_by_default():
    """``device=None`` means CUDA: with no card the entry points raise
    instead of running on the CPU."""
    from ab_opt_tpu_torch.runners.design import BatchedSampler
    model, _ = _tiny()
    if torch.cuda.is_available():
        assert Trainer(model, TRAIN_CFG).device.type == 'cuda'
        assert BatchedSampler(model).device.type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Trainer(model, TRAIN_CFG)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        BatchedSampler(model)
    assert Trainer(model, TRAIN_CFG, device='cpu').device.type == 'cpu'
