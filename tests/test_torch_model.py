"""The port's DiffAb network against the JAX DiffAbNet with the same
(converted) weights: embeddings and encode (float32, atol 1e-4), the
denoiser EpsilonNet (float32, atol 5e-4); plus the weight bridge round trip,
the synthetic complex, and that the package imports without JAX."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from ab_opt_tpu_torch.data.collate import to_device_batch  # noqa: E402
from ab_opt_tpu_torch.models import DiffAb, DiffAbConfig  # noqa: E402
from ab_opt_tpu_torch.utils.convert import params_to_state_dict  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_models(L=24, num_layers=2, num_steps=4, F=32, C=16, seed=0,
                 noise=0.05):
    """A JAX DiffAb (einsum IPA, float32) with perturbed random params, the
    port DiffAb carrying the same weights, and one synthetic complex."""
    from ab_opt_tpu.models import DiffAb as JDiffAb
    from ab_opt_tpu.models import DiffAbConfig as JConfig
    from ab_opt_tpu.utils.bench_fixture import synthetic_batch
    kw = dict(res_feat_dim=F, pair_feat_dim=C, num_layers=num_layers,
              num_steps=num_steps)
    jmodel = JDiffAb(JConfig(ipa_impl='einsum', **kw))
    jbatch = synthetic_batch(np.random.default_rng(seed), N=1, L=L, n_ab=16,
                             gen_lo=6, gen_hi=12)
    params = jmodel.init(jax.random.key(seed), jbatch)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + noise * rng.standard_normal(np.shape(a)).astype(np.float32), params)
    tmodel = DiffAb(DiffAbConfig(**kw))
    tmodel.load_state_dict(params_to_state_dict(params))
    tbatch = to_device_batch({k: np.array(v) for k, v in jbatch.items()})
    return jmodel, params, jbatch, tmodel, tbatch


@pytest.fixture(scope='module')
def models():
    return small_models()


@pytest.mark.parametrize('remove', [True, False])
@pytest.mark.parametrize('part', ['res_feat', 'pair_feat', 'R', 'p'])
def test_encode_matches_jax(models, part, remove):
    jmodel, params, jbatch, tmodel, tbatch = models
    i = ('res_feat', 'pair_feat', 'R', 'p').index(part)
    want = jmodel.encode(params, jbatch, remove, remove)[i]
    with torch.no_grad():
        got = tmodel.encode(tbatch, remove, remove)[i]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize('path', ['module', 'sampler'])
@pytest.mark.parametrize('reps', [1, 2])
def test_epsilon_net_matches_jax(models, path, reps):
    """``module``: eager GAEncoder + per-head MLPs; ``sampler``: the GABlock
    layer path (its plain version on CPU) + batched heads."""
    from ab_opt_tpu.models.diffab import DiffAbNet as JNet
    jmodel, params, jbatch, tmodel, tbatch = models
    res_feat, pair_feat, _, _ = jmodel.encode(params, jbatch, True, True)
    rep = lambda a: np.repeat(np.asarray(a), reps, 0)
    rng = np.random.default_rng(reps)
    N, L = reps, res_feat.shape[1]
    v = (rng.normal(size=(N, L, 3)) * 0.7).astype(np.float32)
    p = rng.normal(size=(N, L, 3)).astype(np.float32)
    s = rng.integers(0, 20, (N, L)).astype(np.int32)
    beta = np.full((N,), 0.3, np.float32)
    gen, mres = rep(jbatch['generate_flag']), rep(jbatch['mask'])
    rf = rep(res_feat)
    want = jmodel.net.apply(params, jnp.asarray(v), jnp.asarray(p),
                            jnp.asarray(s), jnp.asarray(rf), pair_feat,
                            jnp.asarray(beta), jnp.asarray(gen),
                            jnp.asarray(mres), reps=reps,
                            method=JNet.denoise_step)
    tt = torch.from_numpy
    args = (tt(v), tt(p), tt(s).long(), tt(rf), tt(np.array(pair_feat)),
            tt(beta), tt(gen), tt(mres))
    kw = {}
    if path == 'sampler':
        enc, hw = tmodel.prepare_denoiser(args[4], args[7], reps)
        kw = dict(encoder_fn=enc, head_weights=hw)
    with torch.no_grad():
        got = tmodel.eps_net(*args, reps=reps, **kw)
    for i in (1, 2, 3, 4):   # R_next, eps_pos, c_denoised, prmsd_logits
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   atol=5e-4, rtol=0)


def test_weight_bridge_round_trip():
    """port state_dict -> convert_diffab_state_dict -> params_to_state_dict
    gives back the same dict."""
    from ab_opt_tpu.utils.torch_convert import convert_diffab_state_dict
    torch.manual_seed(0)
    model = DiffAb(DiffAbConfig(res_feat_dim=32, pair_feat_dim=16,
                                num_layers=2))
    sd = model.state_dict()
    back = params_to_state_dict(convert_diffab_state_dict(sd, num_layers=2))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, atol=0, rtol=0, msg=k)


def test_synthetic_batch_matches_jax():
    from ab_opt_tpu.utils.bench_fixture import synthetic_batch as j_batch
    from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch
    kw = dict(N=2, L=32, n_ab=20, gen_lo=8, gen_hi=14)
    want = j_batch(np.random.default_rng(4), **kw)
    got = synthetic_batch(np.random.default_rng(4), **kw)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_package_imports_without_jax():
    """Every module of ab_opt_tpu_torch, and chip_smoke.py, imports in a
    fresh interpreter without pulling in jax, flax or any module of the JAX
    package ab_opt_tpu."""
    code = (
        'import importlib, pkgutil, sys\n'
        'import ab_opt_tpu_torch, chip_smoke\n'
        'for m in pkgutil.walk_packages(ab_opt_tpu_torch.__path__,\n'
        '                               "ab_opt_tpu_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = sorted(k for k in sys.modules\n'
        '             if k.split(".")[0] in ("jax", "jaxlib", "flax")\n'
        '             or k == "ab_opt_tpu" or k.startswith("ab_opt_tpu."))\n'
        'assert not bad, bad\n'
        'print("imported", len([k for k in sys.modules\n'
        '                       if k.startswith("ab_opt_tpu_torch")]))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_sources_name_no_jax():
    """No source of the port, nor chip_smoke.py, imports jax, flax or the
    JAX package ab_opt_tpu."""
    import re
    pat = re.compile(r'^\s*(import|from)\s+(jax|jaxlib|flax|ab_opt_tpu)\b'
                     r'(?!_torch)', re.M)
    root = os.path.join(REPO, 'ab_opt_tpu_torch')
    paths = [os.path.join(REPO, 'chip_smoke.py')]
    for dirpath, _, files in os.walk(root):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith('.py')]
    assert len(paths) > 20
    for path in paths:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_constants_copy_matches_jax_package():
    from ab_opt_tpu import constants as J
    from ab_opt_tpu_torch import constants as T
    assert (T.AA_UNK, T.MAX_AA_TYPES) == (J.AA_UNK, J.MAX_AA_TYPES)
    assert ({a.name: int(a) for a in T.BBHeavyAtom}
            == {a.name: int(a) for a in J.BBHeavyAtom})
    for name in ('backbone_atom_coordinates', 'bb_oxygen_coordinate'):
        got, want = getattr(T, name), getattr(J, name)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=name)
