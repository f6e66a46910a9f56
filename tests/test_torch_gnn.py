"""The port's AbDesign graph path (``nn/egnn.py``, ``models/diff_gnn.py``,
``PositionTransition.denoise_from_p0`` and the weight bridge) against the
JAX package's, on the CPU, with JAX's weights carried over by
``utils/convert.py::diff_gnn_params_to_state_dict``:

* the bridge round-trips JAX params through JAX's own
  ``convert_diff_gnn_state_dict`` bit for bit (hotspot embedding, sparse
  and dense stacks), and the port's modules carry every key;
* ``build_adjacency`` exactly, ``radial_features`` within 1e-6 on two
  complexes of unequal sizes in one batch (the norm spans the batch),
  ``interpolate_masked_coords`` within 1e-6 with a row that generates
  nothing, ``denoise_from_p0`` within 1e-6 (noise zeroed where t <= 1);
* each layer (DenseMCEGCL, DenseMCAttention, DenseSeqGNN, DenseMCAttEGNN
  with ``dense`` False and True) within 1e-5;
* ``DiffGNN.loss`` at fixed t with JAX's draws and dropout 0: each term
  within 1e-5 relative, the gradients' cosine >= 0.9999 and each
  parameter's gradient within 1e-4; finite gradients on a padded batch;
  the hotspot embedding's refusal of a batch without hotspot codes.

JAX side: hidden 16, edge 8, 1-2 layers, 6 steps, N 2, L 24; the inits
are jitted once in a module fixture, the loss and its gradients run once op
by op (see ``jax_loss``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from ab_opt_tpu_torch.models import DiffGNN, DiffGNNConfig  # noqa: E402
from ab_opt_tpu_torch.nn import egnn as TE  # noqa: E402
from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch  # noqa: E402
from ab_opt_tpu_torch.utils.convert import (  # noqa: E402
    diff_gnn_params_to_state_dict)

N, L, STEPS = 2, 24, 6
KW = dict(res_feat_dim=16, edge_feat_dim=8, hidden_size=16, num_steps=STEPS,
          dropout=0.0)
tt = lambda a: torch.from_numpy(np.array(a))


def gnn_batch(seed=0, n_pad=0, N=N, L=L):
    """A synthetic batch with the graph model's channels (hotspot codes,
    hydropathy and charge labels); with ``n_pad``, the last ``n_pad``
    residues of complex 1 are padding, as PaddingCollate writes it."""
    from ab_opt_tpu_torch.constants import aa_hydropathy_table
    b = {k: v.numpy() for k, v in synthetic_batch(
        np.random.default_rng(seed), N=N, L=L, n_ab=16, gen_lo=6,
        gen_hi=12).items()}
    rng = np.random.default_rng(seed + 100)
    b['hotspot_label'] = rng.integers(1, 3, (N, L))
    b['hydropathy'] = np.where(b['generate_flag'],
                               aa_hydropathy_table[b['aa']], 3)
    b['charge'] = rng.integers(1, 5, (N, L))
    if n_pad:
        sl = np.s_[1, L - n_pad:]
        for k, v in (('mask', False), ('generate_flag', False), ('aa', 21),
                     ('pos_heavyatom', 0.0), ('mask_heavyatom', False),
                     ('fragment_type', 0), ('res_nb', 0), ('chain_nb', 0),
                     ('hotspot_label', 0), ('hydropathy', 0), ('charge', 0)):
            b[k][sl] = v
    return b


def port_batch(b):
    from ab_opt_tpu_torch.data.collate import to_device_batch
    return to_device_batch(b)


def _perturbed(params, seed=1, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + scale * rng.standard_normal(np.shape(a)).astype(np.float32), params)


def port_model(params, **kw):
    model = DiffGNN(DiffGNNConfig(**dict(KW, **kw)))
    model.load_state_dict(diff_gnn_params_to_state_dict(params))
    return model


@pytest.fixture(scope='module')
def models():
    """JAX DiffGNN params for the sparse stack (2 layers) and the dense one
    (1 layer), each initialised once (jitted) and perturbed so that the
    near-zero coordinate heads move the coordinates."""
    from ab_opt_tpu.models import DiffGNN as JDiffGNN
    from ab_opt_tpu.models import DiffGNNConfig as JConfig
    batch = gnn_batch()
    out = {}
    for name, kw in (('sparse', dict(n_layers=2)),
                     ('dense', dict(n_layers=1, dense=True))):
        jm = JDiffGNN(JConfig(**dict(KW, **kw)))
        params = _perturbed(jax.jit(jm.init)(jax.random.key(0), batch))
        out[name] = (jm, params, kw)
    return out


@pytest.mark.parametrize('name', ['sparse', 'dense'])
def test_bridge_round_trips_jax_params(models, name):
    from ab_opt_tpu.utils.torch_convert import convert_diff_gnn_state_dict
    _, params, kw = models[name]
    sd = diff_gnn_params_to_state_dict(params)
    model = DiffGNN(DiffGNNConfig(**dict(KW, **kw)))
    assert sorted(sd) == sorted(model.state_dict())
    back = convert_diff_gnn_state_dict(
        {k: v.numpy() for k, v in sd.items()}, n_layers=kw['n_layers'],
        hidden=KW['hidden_size'], n_channel=3,
        edge_feat_dim=KW['edge_feat_dim'])
    flat = lambda p: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_leaves_with_path(p)}
    want, got = flat(params), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_build_adjacency_exact():
    from ab_opt_tpu.nn.egnn import build_adjacency as J
    b = gnn_batch(seed=3, n_pad=5)
    ca = b['pos_heavyatom'][:, :, 1]
    for cut in ((8.0, 12.0), (5.0, 9.5)):
        want = J(ca, b['fragment_type'], b['mask'], *cut)
        got = TE.build_adjacency(tt(ca), tt(b['fragment_type']),
                                 tt(b['mask']), *cut)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[0].sum() > 0 and got[1].sum() > 0


def _coords_and_adj(seed=4, n_pad=7):
    """Noisy 3-channel coords of two complexes of unequal sizes, and their
    ctx and inter adjacency."""
    b = gnn_batch(seed=seed, n_pad=n_pad)
    rng = np.random.default_rng(seed)
    x = (b['pos_heavyatom'][:, :, :3] / 10.0
         + 0.05 * rng.standard_normal((N, L, 3, 3))).astype(np.float32)
    x[~b['mask']] = 0.0
    ctx, inter = TE.build_adjacency(tt(b['pos_heavyatom'][:, :, 1]),
                                    tt(b['fragment_type']), tt(b['mask']))
    return b, x, ctx.numpy(), inter.numpy()


def test_radial_features_two_sizes():
    from ab_opt_tpu.nn.egnn import radial_features as J
    _, x, ctx, _ = _coords_and_adj()
    want = J(jnp.asarray(x), jnp.asarray(ctx))
    got = TE.radial_features(tt(x), tt(ctx))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    # The norm spans both complexes: per complex it would differ.
    alone = TE.radial_features(tt(x[:1]), tt(ctx[:1]))[0]
    assert not np.allclose(alone.numpy(), got[0][:1].numpy(), atol=1e-3)


def test_interpolate_masked_coords():
    from ab_opt_tpu.models.diff_gnn import interpolate_masked_coords as J
    from ab_opt_tpu_torch.models.diff_gnn import interpolate_masked_coords
    rng = np.random.default_rng(5)
    coord = rng.standard_normal((3, L, 3, 3)).astype(np.float32) * 10
    gen = np.zeros((3, L), bool)
    gen[0, 6:12] = True
    gen[1, 0:3] = True                          # the span starts at 0
    mask = np.ones((3, L), bool)
    mask[1, -4:] = False                        # row 2 generates nothing
    want = np.asarray(J(jnp.asarray(coord), jnp.asarray(gen),
                        jnp.asarray(mask)))
    got = interpolate_masked_coords(tt(coord), tt(gen), tt(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[2], coord[2])


@pytest.mark.parametrize('t', [1, 2, 3, STEPS])
def test_denoise_from_p0_matches_jax(t):
    from ab_opt_tpu import diffusion as JD
    from ab_opt_tpu_torch import diffusion as TD
    j, p = JD.PositionTransition.create(STEPS), TD.PositionTransition(STEPS)
    rng = np.random.default_rng(t)
    p_t, p_0 = (rng.standard_normal((N, L, 3)).astype(np.float32)
                for _ in range(2))
    gen = gnn_batch()['generate_flag']
    key = jax.random.key(t)
    want = j.denoise_from_p0(key, jnp.asarray(p_t), jnp.asarray(p_0),
                             jnp.asarray(gen), jnp.asarray(t))
    z = tt(jax.random.normal(key, (N, L, 3)))
    got = p.denoise_from_p0(tt(p_t), tt(p_0), tt(gen), t, z=z)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    if t <= 1:     # no noise: the posterior mean itself
        np.testing.assert_array_equal(
            got.numpy(), p.denoise_from_p0(tt(p_t), tt(p_0), tt(gen), t,
                                           z=z * 7).numpy())


def _jax_layer(cls_name, params, *args, **kw):
    from ab_opt_tpu.nn import egnn as JE
    mod = getattr(JE, cls_name)(**kw)
    return mod.apply({'params': params}, *args)


@pytest.mark.parametrize('layer', ['gcl', 'attention', 'seqgnn', 'egnn',
                                   'egnn_dense'])
def test_layer_matches_jax(models, layer):
    b, x, ctx, inter = _coords_and_adj()
    rng = np.random.default_rng(6)
    F, E, C = KW['hidden_size'], KW['edge_feat_dim'], 3
    h = rng.standard_normal((N, L, F)).astype(np.float32)
    e = (rng.standard_normal((N, L, L, E)) * ctx[..., None]).astype(
        np.float32)
    name = 'dense' if layer == 'egnn_dense' else 'sparse'
    _, params, kw = models[name]
    model = port_model(params, **kw)
    g = params['params']['gnn']
    T = lambda *a: [tt(v) for v in a]
    with torch.no_grad():
        if layer == 'gcl':
            want = _jax_layer('DenseMCEGCL', g['gcl_0'], h, x, ctx, e,
                              hidden_nf=F, n_channel=C, edges_in_d=E)
            got = model.gnn.gcl_0(*T(h, x, ctx, e))
        elif layer == 'attention':
            want = _jax_layer('DenseMCAttention', g['att_0'], h, x, inter,
                              hidden_nf=F, n_channel=C)
            got = model.gnn.att_0(*T(h, x, inter))
        elif layer == 'seqgnn':
            want = [_jax_layer('DenseSeqGNN', params['params']['seqgnn'], h,
                               x, inter, b['hydropathy'], b['charge'],
                               hidden_nf=F, n_channel=C)]
            got = [model.seqgnn(*T(h, x, inter, b['hydropathy'],
                                   b['charge']))]
        else:
            h_in = rng.standard_normal((N, L, KW['res_feat_dim'])).astype(
                np.float32)
            cond = rng.uniform(0, 0.5, (N, L)).astype(np.float32)
            want = _jax_layer('DenseMCAttEGNN', g, h_in, x, ctx, inter, cond,
                              e, hidden_nf=F, out_node_nf=F, n_channel=C,
                              in_edge_nf=E, n_layers=kw['n_layers'],
                              dense=kw.get('dense', False))
            got = model.gnn(*T(h_in, x, ctx, inter, cond, e))
    assert len(got) == len(want)
    for w, g_ in zip(want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(g_.numpy(), w, atol=1e-5, rtol=0)
        assert np.abs(w).max() > 1e-3


def test_coordinates_move(models):
    """The perturbed coordinate heads move the coordinates, so the layer
    tests hold the coordinate update, not an identity."""
    _, x, ctx, _ = _coords_and_adj()
    _, params, kw = models['sparse']
    model = port_model(params, **kw)
    h = torch.randn(N, L, KW['hidden_size'], generator=torch.Generator()
                    .manual_seed(0))
    e = torch.zeros(N, L, L, KW['edge_feat_dim'])
    with torch.no_grad():
        _, x2 = model.gnn.gcl_0(h, tt(x), tt(ctx), e)
    assert (x2 - tt(x)).abs().max() > 1e-3


LOSS_KEY, LOSS_T = 9, np.asarray([1, 4], np.int32)


def rot_draws(key, N, L):
    """One IGSO3 vector draw of JAX's from its key (igso3.py:113, 141), under
    the transitions' draw names."""
    from test_torch_train import _igso3_draws
    return {'rot_' + k: v for k, v in _igso3_draws(key, (N, L)).items()}


def loss_draws(key, N, L):
    """JAX DiffGNN.loss's draws from its key (diff_gnn.py:261;
    transitions.py:73)."""
    k_t, k_rot, k_pos, k_drop = jax.random.split(key, 4)
    return dict(rot_draws(k_rot, N, L),
                pos=tt(jax.random.normal(k_pos, (N, L, 3))))


LOSS_TERMS = ('rot', 'pos', 'bb_pos', 'seq')


@pytest.fixture(scope='module')
def jax_loss(models):
    """JAX DiffGNN.loss on a padded batch at LOSS_KEY and LOSS_T and the
    gradients of the sum of its four terms, op by op: jitted, XLA's CPU
    fusions move JAX's own rotation noising by ~2e-4 (the rot term by
    ~5e-4 relative), past the 1e-5 this test holds the port to."""
    jm, params, _ = models['sparse']
    b = gnn_batch(seed=7, n_pad=4)

    def total(p):
        losses = jm.loss(p, b, jax.random.key(LOSS_KEY),
                         t=jnp.asarray(LOSS_T))
        return sum(losses[k] for k in LOSS_TERMS), losses

    (_, losses), grads = jax.value_and_grad(total, has_aux=True)(params)
    return b, losses, grads


def test_loss_and_grads_match_jax(models, jax_loss):
    _, params, kw = models['sparse']
    b, want, grads = jax_loss
    model = port_model(params, **kw)
    got = model.loss(port_batch(b), t=tt(LOSS_T),
                     draws=loss_draws(jax.random.key(LOSS_KEY), N, L))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert not got['accuracy'].requires_grad
    sum(got[k] for k in LOSS_TERMS).backward()
    want_g = diff_gnn_params_to_state_dict(grads)
    got_g = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    for k, w in want_g.items():
        g = got_g[k] if got_g[k] is not None else torch.zeros_like(w)
        assert torch.isfinite(g).all(), k
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=0,
                                   err_msg=k)
    flat = lambda d: torch.cat([d[k].flatten() for k in sorted(want_g)])
    gw = flat(want_g)
    gg = flat({k: (v if v is not None else torch.zeros_like(want_g[k]))
               for k, v in got_g.items()})
    cos = float(gw @ gg / (gw.norm() * gg.norm()))
    assert cos >= 0.9999, cos


def test_loss_with_dropout_draws_from_generator(models):
    """Dropout is on in every loss call (as JAX's), its masks from the
    call's generator: one seed gives one loss, another a different one."""
    _, params, kw = models['sparse']
    model = port_model(params, **dict(kw, dropout=0.3))
    batch = port_batch(gnn_batch(seed=2))
    t = tt(LOSS_T)
    draws = loss_draws(jax.random.key(1), N, L)
    run = lambda s: model.loss(batch, torch.Generator().manual_seed(s), t=t,
                               draws=draws)['pos'].detach()
    assert float(run(0)) == float(run(0))
    assert float(run(0)) != float(run(1))


def test_padded_batch_gives_finite_grads(models):
    _, params, kw = models['sparse']
    model = port_model(params, **kw)
    b = gnn_batch(seed=8, n_pad=6)
    losses = model.loss(port_batch(b), torch.Generator().manual_seed(0))
    sum(losses[k] for k in LOSS_TERMS).backward()
    for k, p in model.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), k
    for k in LOSS_TERMS:
        assert torch.isfinite(losses[k]), k


def test_hotspot_embedding_needs_codes(models):
    _, params, kw = models['sparse']
    model = port_model(params, **kw)
    b = gnn_batch()
    del b['hotspot_label']
    with pytest.raises(ValueError, match='hotspot_label'):
        model.loss(port_batch(b))
    plain = DiffGNN(DiffGNNConfig(**dict(KW, hotspot=False)))
    assert 'embed.residue_embed.hotspot_embed.weight' not in plain.state_dict()
    assert torch.isfinite(plain.loss(port_batch(b))['seq'])


def test_bfloat16_config_trains_and_samples():
    """``dtype: bfloat16`` follows DiffAb's convention: float32 parameters,
    bf16 Dense and Embed compute; the loss, its gradients and a sample stay
    finite."""
    model = DiffGNN(DiffGNNConfig(**dict(KW, n_layers=2, dtype='bfloat16')))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    batch = port_batch(gnn_batch(seed=9, n_pad=4))
    losses = model.loss(batch, torch.Generator().manual_seed(0))
    sum(losses[k] for k in LOSS_TERMS).backward()
    for k in LOSS_TERMS:
        assert torch.isfinite(losses[k]), k
    for k, p in model.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), k
    out = model.sample(batch, torch.Generator().manual_seed(0),
                       num_replicas=2)
    assert all(torch.isfinite(out[k]).all() for k in ('v', 'p'))


def test_trainer_steps_a_gnn_and_its_loss_takes_no_attention_hook(models):
    """The Trainer passes DiffAb's ``attention`` hook only when it is set;
    the graph model's loss refuses it rather than ignoring it."""
    from ab_opt_tpu_torch.train import Trainer
    _, params, kw = models['sparse']
    model = port_model(params, **kw)
    trainer = Trainer(model, {'loss_weights': {'rot': 1.0, 'pos': 1.0,
                                               'bb_pos': 1.0, 'seq': 1.0}},
                      device='cpu')
    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses = trainer.train_step(gnn_batch(seed=10),
                                torch.Generator().manual_seed(0))
    assert torch.isfinite(losses['bb_pos']) and trainer.iteration == 1
    assert any(not torch.equal(before[k], v)
               for k, v in model.state_dict().items())
    with pytest.raises(TypeError, match='attention'):
        trainer.loss_and_grads(port_batch(gnn_batch()),
                               attention=lambda *a: None)
