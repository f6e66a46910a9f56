"""S4, the fused-GABlock variant harness
(ab_opt_tpu_torch.ops.gablock_variants), against the JAX package on the
CPU:

* the plain versions against the script's own Pallas bodies,
  ``scripts/micro_fused_variants.py`` ``_gablock_kernel_v3`` and
  ``_gablock_kernel_abl`` through its ``run_layer``, in interpret mode: the
  script is loaded as a module of its own and its ``pl`` replaced by one
  whose ``pallas_call`` interprets (the script itself is not changed). The
  weights are a perturbed JAX GABlock's, bundled by the JAX
  ``build_gablock_weights`` with ``w_pts`` put back in the component-major
  column order the script's bodies read (the bundle now emits it
  operand-major); the port gets the same block. bf16, L=16, 3 padded rows,
  atol/rtol 0.05 on valid rows (K1's budget): v3 against K1's plain
  version; abl under each flag with a counterpart and under the floor
  against the plain version with the same flags;
* what has no counterpart: ``skip_out`` and ``skip_wpts`` leave the
  script's output exactly as it is, and the production bundle as it is
  puts v3 off by more than 1.0 (the layout trap);
* the wrappers: they refuse what the card kernel does not take (dtype, L,
  ``rt`` not dividing reps, a flag set the kernel has no mask for, a tensor
  off the card, a tensor that requires a gradient), and CPU tensors take
  the plain version with no launch;
* the harness (ab_opt_tpu_torch.utils.micro_fused): what it times, and
  that it runs nothing on CPU inputs.
The kernels themselves are held against the plain versions on a card in
tests/test_torch_cuda.py.
"""
import functools
import importlib.util
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from ab_opt_tpu_torch.nn.ipa import precompute_pair_bias  # noqa: E402
from ab_opt_tpu_torch.ops import gablock as gb  # noqa: E402
from ab_opt_tpu_torch.ops import gablock_variants as gv  # noqa: E402
from test_torch_gablock import _case  # noqa: E402

SCRIPT = (pathlib.Path(__file__).resolve().parents[1] / 'scripts'
          / 'micro_fused_variants.py')
TOL = 0.05


@pytest.fixture(scope='module')
def script():
    """micro_fused_variants.py as a private module whose Pallas calls run
    in interpret mode."""
    spec = importlib.util.spec_from_file_location('_micro_fused_variants',
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    return mod


def _component_major(wb):
    """The bundle with ``w_pts`` in the column order the script reads:
    [c=0: qp | kp | vp][c=1: ...][c=2: ...], undoing the operand-major
    permutation of ``build_gablock_weights``."""
    H, _, _, P, PV = wb['dims']
    HP, HPV = H * P, H * PV
    n_tot = 2 * HP + HPV
    perm = np.concatenate(
        [np.arange(c * n_tot + off, c * n_tot + off + w)
         for off, w in ((0, HP), (HP, HP), (2 * HP, HPV)) for c in range(3)])
    return dict(wb, w_pts=wb['w_pts'][:, np.argsort(perm)])


@functools.lru_cache(maxsize=None)
def _layer(Nc, reps, n_pad=3, seed=5):
    """One seeded case at L=16: the script's operands and bundles
    (component-major and as built), and the port's arguments."""
    from ab_opt_tpu.ops.gablock_pallas import build_gablock_weights
    from ab_opt_tpu.ops.ipa_pallas import precompute_pair_bias as j_bias
    _, params, tblock, c = _case(Nc, reps, n_pad=n_pad, seed=seed)
    bp = jax.tree_util.tree_map(jnp.asarray, params['params'])
    bf = jnp.bfloat16
    N, L = c['mask'].shape
    zb = jnp.asarray(c['z']).astype(bf)
    jax_ops = (jnp.asarray(c['x']), jnp.asarray(c['R']).reshape(N, L, 9),
               jnp.asarray(c['t']), zb,
               j_bias(zb, bp['proj_pair_bias']['kernel'].astype(bf),
                      jnp.asarray(c['mask_c']), out_dtype=bf),
               jnp.asarray(c['mask'], jnp.float32)[..., None])
    wb = build_gablock_weights(bp)
    tt = torch.from_numpy
    z = tt(c['z']).to(torch.bfloat16)
    with torch.no_grad():
        bias = precompute_pair_bias(
            z, tblock.proj_pair_bias.weight.detach().t(), tt(c['mask_c']),
            torch.bfloat16)
        twb = gb.build_gablock_weights(tblock, torch.bfloat16)
    port = (tt(c['x']), tt(c['R']).reshape(N, L, 9), tt(c['t']), z, bias,
            tt(c['mask']).float(), twb, reps)
    return jax_ops, _component_major(wb), wb, port, c['mask']


def _run(script, body, Nc, reps, rt, extra=None, as_built=False):
    """The script's ``run_layer`` over ``body``; ``as_built``: with the
    bundle as ``build_gablock_weights`` emits it."""
    jax_ops, wb_cm, wb, _, _ = _layer(Nc, reps)
    return np.asarray(script.run_layer(body, *jax_ops,
                                       wb if as_built else wb_cm, reps, rt,
                                       extra))


def _close(got, want, valid):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], want[valid], atol=TOL, rtol=TOL)


@pytest.mark.parametrize('Nc,reps,rt', [(2, 1, 1), (1, 4, 2), (1, 4, 4)])
def test_v3_plain_version_matches_the_script(script, Nc, reps, rt):
    """v3's plain version (K1's) against ``_gablock_kernel_v3``; the
    wrapper on CPU tensors launches nothing."""
    want = _run(script, script._gablock_kernel_v3, Nc, reps, rt)
    *_, port, valid = _layer(Nc, reps)
    gv.reset_counts()
    with torch.no_grad():
        got = gv.gablock_layer_v3(*port, rt=rt)
    assert gv.launches == {'v3': 0, 'abl': 0}
    assert gb.gablock_layer_reference.calls == 1
    _close(got, want, valid)


@pytest.mark.parametrize('flags', [()] + list(gv.ABLATIONS),
                         ids=lambda f: '+'.join(f) if len(f) < 3 else 'floor')
def test_abl_plain_version_matches_the_script(script, flags):
    """The plain version under each flag with a counterpart, under the
    floor (the script's less ``skip_sect``) and under none, against
    ``_gablock_kernel_abl`` with the same flags: 2 replicas of one complex
    in one script tile."""
    want = _run(script, script._gablock_kernel_abl, 1, 2, 2,
                {f: True for f in flags})
    *_, port, valid = _layer(1, 2)
    gv.reset_counts()
    with torch.no_grad():
        got = gv.gablock_layer_abl(*port, flags=flags)
    assert gv.launches == {'v3': 0, 'abl': 0}
    assert gv.gablock_layer_abl_reference.calls == 1
    _close(got, want, valid)


@pytest.mark.parametrize('flag', ['skip_out', 'skip_wpts'])
def test_flags_the_script_never_reads(script, flag):
    """``skip_out`` and ``skip_wpts`` leave the script's output exactly as
    it is; the port maps them to the baseline, exactly."""
    body = script._gablock_kernel_abl
    want = _run(script, body, 1, 2, 2, {})
    np.testing.assert_array_equal(
        _run(script, body, 1, 2, 2, {flag: True}), want)
    *_, port, _ = _layer(1, 2)
    assert gv.abl_mask((flag,)) == 0
    with torch.no_grad():
        torch.testing.assert_close(gv.gablock_layer_abl(*port, flags=(flag,)),
                                   gv.gablock_layer_abl(*port), atol=0,
                                   rtol=0)


def test_the_production_bundle_puts_v3_off(script):
    """The layout trap: the script's bodies slice ``w_pts`` component-major,
    the bundle emits it operand-major, so fed the bundle as it is v3 is off
    from K1's function by more than 1.0 (and within the budget once the
    columns are put back)."""
    *_, port, valid = _layer(1, 4)
    with torch.no_grad():
        ref = gb.gablock_layer_reference(*port).numpy()
    as_built = _run(script, script._gablock_kernel_v3, 1, 4, 2,
                    as_built=True)
    assert np.abs(as_built[valid] - ref[valid]).max() > 1.0
    _close(ref, _run(script, script._gablock_kernel_v3, 1, 4, 2), valid)


# ------------------------------------------------------------ the wrappers


def _meta(dtype=torch.float32, L=32, reps=4, N=4, H=12):
    """K1-shaped arguments on the meta device (shapes, no data)."""
    f32, bf16 = torch.float32, torch.bfloat16
    e = lambda *s, dtype=f32: torch.empty(*s, dtype=dtype, device='meta')
    F, Nc = 128, N // reps
    wb = {'w_proj': e(F, 2048, dtype=bf16), 'coef': e(H),
          'w_out': e(H * 152, F, dtype=bf16), 'b_out': e(F), 'ln1': e(2, F),
          'w_m1': e(F, F, dtype=bf16), 'w_m2': e(F, F, dtype=bf16),
          'w_m3': e(F, F, dtype=bf16), 'b_m': e(3, F), 'ln2': e(2, F),
          'dims': (H, 32, 32, 8, 8)}
    return [e(N, L, F, dtype=dtype), e(N, L, 9), e(N, L, 3),
            e(Nc, L, L, 64, dtype=bf16), e(Nc, H, L, L, dtype=bf16),
            e(N, L), wb, reps]


CALLS = {'v3': lambda a, **kw: gv.gablock_layer_v3(*a, rt=kw.get('rt', 2)),
         'abl': lambda a, **kw: gv.gablock_layer_abl(
             *a, flags=kw.get('flags', ('skip_rot',)))}


@pytest.mark.parametrize('variant', list(CALLS))
@pytest.mark.parametrize('bad,kw,match', [
    (dict(dtype=torch.float16), {}, 'x dtype'),
    (dict(L=24), {}, 'L=24'), (dict(L=272), {}, 'L=272'),
    ({}, {}, 'CUDA device')])
def test_wrapper_rejects_what_the_kernel_does_not_take(variant, bad, kw,
                                                       match):
    gv.reset_counts()
    with pytest.raises(ValueError, match=match):
        CALLS[variant](_meta(**bad), **kw)
    assert gv.launches == {'v3': 0, 'abl': 0}


@pytest.mark.parametrize('kw,match', [
    (dict(rt=3), 'rt=3 must divide reps=4'), (dict(rt=0), 'rt=0')])
def test_v3_refuses_an_rt_that_does_not_tile_the_replicas(kw, match):
    with pytest.raises(ValueError, match=match):
        CALLS['v3'](_meta(), **kw)


@pytest.mark.parametrize('flags,match', [
    (('skip_rot', 'skip_sq'), 'the kernel takes none, one flag'),
    (('skip_everything',), 'unknown flags')])
def test_abl_refuses_a_flag_set_the_kernel_has_no_mask_for(flags, match):
    with pytest.raises(ValueError, match=match):
        CALLS['abl'](_meta(), flags=flags)
    # The plain version takes any set of the script's flags.
    if flags[0] == 'skip_rot':
        *_, port, _ = _layer(1, 2)
        with torch.no_grad():
            gv.gablock_layer_abl_reference(*port, flags=flags)


@pytest.mark.parametrize('variant', list(CALLS))
@pytest.mark.parametrize('which', range(6))
def test_wrapper_raises_on_a_tensor_that_requires_grad(variant, which):
    """x, R9, t, z, bias and mask, one at a time; nothing is computed."""
    *_, port, _ = _layer(1, 2)
    args = list(port[:6]) + list(port[6:])
    args[which] = args[which].detach().clone().requires_grad_()
    gv.reset_counts()
    with pytest.raises(ValueError, match='requires a gradient'):
        CALLS[variant](args)
    assert gb.gablock_layer_reference.calls == 0
    assert gv.gablock_layer_abl_reference.calls == 0


def test_harness_times_every_variant_and_refuses_cpu_inputs():
    """The harness times K1, v3, the abl baseline, each flag with a
    counterpart and the floor, and runs nothing on CPU inputs."""
    from ab_opt_tpu_torch.utils import micro_fused as mf
    names = list(mf.variants(4))
    assert names[:3] == ['K1', 'v3 rt=4', 'abl baseline']
    assert names[3:] == [f'abl {f}' for f in gv.ABL_BITS] + ['abl floor']
    *_, port, _ = _layer(1, 2)
    gv.reset_counts()
    with pytest.raises(RuntimeError, match='CUDA device'):
        mf.time_variants(port, 2)
    assert gv.launches == {'v3': 0, 'abl': 0}
    assert gb.gablock_layer_reference.calls == 0
    assert mf.medians({'a': [3.0, 1.0, 2.0, 9.0]}) == {'a': 2.5}


def test_kernel_masks():
    """One bit a flag with a counterpart; the floor is the script's floor
    less ``skip_sect``; 11 masks in all."""
    assert set(gv.FLAGS) == set(gv.ABL_BITS) | set(gv.NO_COUNTERPART)
    assert len(gv.FLAGS) == 12
    assert gv.abl_mask(gv.FLOOR + ('skip_sect',)) == gv.abl_mask(gv.FLOOR)
    assert gv.abl_mask(('skip_sect',)) == 0
    assert len(gv.KERNEL_MASKS) == 11
