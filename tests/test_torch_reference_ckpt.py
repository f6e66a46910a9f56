"""Reference (pengzhangzhi/ab_opt) torch checkpoints into the port
(``utils/torch_convert.py``, ``train/checkpoint.py::read_reference_checkpoint``,
``runners/convert_checkpoint.py``) against the JAX package's converter
(``ab_opt_tpu/utils/torch_convert.py``, ``scripts/convert_checkpoint.py``).

The reference-format files are written by
``utils/bench_fixture.py::write_reference_checkpoint``: a port model's
state dict (the port keeps the reference's names and layouts) plus
buffer-like keys whose names and shapes are NOT verified against a
released file (none is in the repository), the config pickled as
``easydict.EasyDict`` through a stand-in module that is in
``sys.modules`` only while saving, an Adam state, a scheduler state and
the iteration.

* the port's converter in process and as a subprocess that cannot import
  easydict, dynamic_yaml, jax or the JAX package, and the JAX script as a
  subprocess with the stand-in on its path, give bitwise-equal state
  dicts, equal configs and equal iterations through ``read_weights``;
* one denoiser evaluation of the JAX model (the JAX script's params)
  against the port model loaded from the converted file (atol 5e-4);
* ``diff_gnn``: the port's conversion equals JAX's GNN converter composed
  with the port's bridge, with and without the hotspot embedding, and
  through the runner;
* refusals: a missing or mis-shaped key names the key; a pickle that
  names ``os.system`` is refused without running it; a reference file
  given where a port checkpoint is read raises a ValueError naming the
  converter (``read_weights``, the design runner, the trainer); port,
  legacy-format and ``dynamic_yaml``-like files read;
* a design request from the converted file equals one from a port
  checkpoint of the same weights, file for file.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from ab_opt_tpu_torch.runners import convert_checkpoint as CC  # noqa: E402
from ab_opt_tpu_torch.runners import design as TD  # noqa: E402
from ab_opt_tpu_torch.train.checkpoint import (  # noqa: E402
    CONVERTER, read_reference_checkpoint, read_weights, save_checkpoint)
from ab_opt_tpu_torch.utils.bench_fixture import (  # noqa: E402
    EASYDICT_SOURCE, easydict_standin, reference_buffers,
    write_reference_checkpoint, write_synthetic_complex)
from ab_opt_tpu_torch.utils.torch_convert import (  # noqa: E402
    convert_diff_gnn_state_dict, convert_diffab_state_dict)
from test_torch_design import _tree  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX's test model (tests/test_checkpoint_convert.py), two layers deep.
MODEL_CFG = {
    'type': 'diffab', 'res_feat_dim': 16, 'pair_feat_dim': 8, 'num_bins': 8,
    'dist_min': 0.5, 'dist_max': 19.5, 'train_structure': True,
    'train_sequence': False, 'initial_patch_size': 0, 'antigen_size': 16,
    'remove_anchor': True,
    'diffusion': {'num_steps': 4, 'eps_net_opt': {'num_layers': 2},
                  'obj': 'pred_x0'},
}
CONFIG = {'model': MODEL_CFG,
          'train': {'batch_size': 4, 'loss_weights': {'rot': 1.0, 'pos': 1.0},
                    'optimizer': {'type': 'adam', 'lr': 1e-4,
                                  'betas': [0.9, 0.999]}},
          'dataset': {'train': {'type': 'sabdab', 'transform': [
              {'type': 'mask_single_cdr'}, {'type': 'merge_chains'}]}}}
GNN_CFG = {'type': 'diff_gnn', 'res_feat_dim': 16, 'edge_feat_dim': 8,
           'hidden_size': 16, 'n_layers': 2, 'num_steps': 4}
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'chex', 'ab_opt_tpu', 'easydict',
           'dynamic_yaml')
FINDER = f'''
import importlib.abc, runpy, sys
BANNED = {BLOCKED!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in BANNED:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
sys.argv = ['convert_checkpoint'] + sys.argv[1:]
runpy.run_module('ab_opt_tpu_torch.runners.convert_checkpoint',
                 run_name='__main__')
bad = sorted(k for k in sys.modules if k.split('.')[0] in BANNED)
assert not bad, bad
print('clean')
'''


def _perturbed(model, seed, noise=0.05):
    """``model`` with every weight moved by seeded normal noise."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(
                noise * rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    return model


def _assert_same_weights(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    """The reference-format file, its three conversions (port in process,
    port in a child without easydict, the JAX script) and the model."""
    root = tmp_path_factory.mktemp('ref')
    model = _perturbed(TD.random_model(MODEL_CFG, seed=3), seed=4)
    src = write_reference_checkpoint(str(root / 'ref_250000.pt'), model,
                                     CONFIG, iteration=250000)
    assert 'easydict' not in sys.modules
    standin = root / 'standin'
    standin.mkdir()
    (standin / 'easydict.py').write_text(EASYDICT_SOURCE)
    out = {'port': str(root / 'port.ckpt'), 'child': str(root / 'child.ckpt'),
           'jax': str(root / 'jax.ckpt')}
    info = CC.convert(src, out['port'])
    child = subprocess.run(
        [sys.executable, '-c', FINDER, src, out['child']], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert child.returncode == 0, child.stderr[-3000:]
    assert child.stdout.strip().endswith('clean')
    assert '2-layer diffab, it 250000, 15 keys dropped' in child.stdout
    script = subprocess.run(
        [sys.executable, os.path.join(REPO, 'scripts', 'convert_checkpoint.py'),
         src, out['jax']], cwd=REPO, capture_output=True, text=True,
        timeout=300,
        env=dict(os.environ, JAX_PLATFORMS='cpu',
                 PYTHONPATH=f'{REPO}{os.pathsep}{standin}'))
    assert script.returncode == 0, script.stderr[-3000:]
    return {'src': src, 'out': out, 'info': info, 'model': model,
            'root': root}


def test_the_converters_agree(ref):
    want = ref['model'].state_dict()
    got = {k: read_weights(v) for k, v in ref['out'].items()}
    for name, w in got.items():
        _assert_same_weights(w['state_dict'], want)
        assert w['config'] == got['jax']['config'], name
        assert w['iteration'] == 250000, name
    assert got['port']['config']['model'] == MODEL_CFG
    assert got['port']['config']['train']['optimizer']['betas'] == [0.9, 0.999]
    assert ref['info']['dropped'] == sorted(reference_buffers(ref['model']))
    saved = torch.load(ref['out']['port'], weights_only=True)
    assert saved['extra'] == {'converted_from': ref['src']}
    assert saved['optimizer'] is None
    with open(ref['out']['jax'], 'rb') as f:
        assert pickle.load(f)['extra'] == {'converted_from': ref['src']}


def test_denoiser_from_the_converted_file_matches_jax(ref):
    from ab_opt_tpu.models import DiffAb as JDiffAb
    from ab_opt_tpu.models.diffab import DiffAbNet as JNet
    from ab_opt_tpu.utils.bench_fixture import synthetic_batch
    import jax.numpy as jnp
    with open(ref['out']['jax'], 'rb') as f:
        params = pickle.load(f)['params']
    jmodel = JDiffAb(dict(MODEL_CFG))
    jbatch = synthetic_batch(np.random.default_rng(0), N=1, L=24, n_ab=16,
                             gen_lo=6, gen_hi=12)
    reps = 2
    res_feat, pair_feat, _, _ = jmodel.encode(params, jbatch, True, True)
    rep = lambda a: np.repeat(np.asarray(a), reps, 0)
    rng = np.random.default_rng(7)
    L = res_feat.shape[1]
    v = (rng.normal(size=(reps, L, 3)) * 0.7).astype(np.float32)
    p = rng.normal(size=(reps, L, 3)).astype(np.float32)
    s = rng.integers(0, 20, (reps, L)).astype(np.int32)
    beta = np.full((reps,), 0.3, np.float32)
    gen, mres, rf = (rep(jbatch['generate_flag']), rep(jbatch['mask']),
                     rep(res_feat))
    want = jmodel.net.apply(params, jnp.asarray(v), jnp.asarray(p),
                            jnp.asarray(s), jnp.asarray(rf), pair_feat,
                            jnp.asarray(beta), jnp.asarray(gen),
                            jnp.asarray(mres), reps=reps,
                            method=JNet.denoise_step)
    model, _ = TD.load_model_from_checkpoint(ref['out']['port'])
    tt = torch.from_numpy
    with torch.no_grad():
        got = model.eps_net(tt(v), tt(p), tt(s).long(), tt(rf),
                            tt(np.array(pair_feat)), tt(beta), tt(gen),
                            tt(mres), reps=reps)
    for i in (1, 2, 3, 4):   # R_next, eps_pos, c_denoised, prmsd_logits
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   atol=5e-4, rtol=0)


@pytest.mark.parametrize('hotspot', [True, False])
def test_diff_gnn_converts_as_jax_and_the_bridge(hotspot, tmp_path):
    from ab_opt_tpu.utils.torch_convert import convert_diff_gnn_state_dict as J
    from ab_opt_tpu_torch.utils.convert import diff_gnn_params_to_state_dict
    cfg = dict(GNN_CFG, hotspot=hotspot)
    model = _perturbed(TD.random_model(cfg, seed=5), seed=6)
    sd = dict(model.state_dict(), **reference_buffers(model))
    dims = dict(n_layers=2, hidden=16, n_channel=3, edge_feat_dim=8)
    got, dropped = convert_diff_gnn_state_dict(sd, **dims)
    want = diff_gnn_params_to_state_dict(J(sd, **dims))
    _assert_same_weights(got, want)
    _assert_same_weights(got, model.state_dict())
    assert ('embed.residue_embed.hotspot_embed.weight' in got) == hotspot
    assert dropped == sorted(reference_buffers(model))
    src = write_reference_checkpoint(str(tmp_path / 'gnn.pt'), model,
                                     {'model': cfg}, iteration=7)
    info = CC.convert(src, str(tmp_path / 'gnn.ckpt'))
    assert (info['type'], info['num_layers']) == ('diff_gnn', 2)
    w = read_weights(str(tmp_path / 'gnn.ckpt'))
    _assert_same_weights(w['state_dict'], want)
    assert (w['config'], w['iteration']) == ({'model': cfg}, 7)


@pytest.mark.parametrize('fault', ['missing', 'shape'])
def test_a_bad_key_is_named(ref, fault):
    sd = dict(read_reference_checkpoint(ref['src'])['state_dict'])
    key = 'diffusion.eps_net.encoder.blocks.1.proj_query_point.weight'
    if fault == 'missing':
        del sd[key]
    else:
        sd[key] = torch.zeros(3, 5)
    other = 'pair_embed.out_mlp.4.bias'
    sd[other] = torch.zeros(9)
    with pytest.raises(ValueError, match=fault if fault == 'missing'
                       else 'wrong shape') as err:
        convert_diffab_state_dict(sd, num_layers=2)
    assert key in str(err.value) and other in str(err.value)
    with pytest.raises(ValueError, match='missing'):
        convert_diffab_state_dict(sd, num_layers=3)


class _Evil:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return os.system, (f'touch {self.marker}',)


def test_a_pickle_naming_os_system_is_refused(tmp_path):
    marker = tmp_path / 'ran'
    path = str(tmp_path / 'evil.pt')
    torch.save({'config': {}, 'model': {'w': torch.zeros(2)},
                'x': _Evil(marker)}, path)
    with pytest.raises(pickle.UnpicklingError, match='system'):
        read_reference_checkpoint(path)
    with pytest.raises(pickle.UnpicklingError):
        CC.convert(path, str(tmp_path / 'out.ckpt'))
    assert not marker.exists()
    assert not (tmp_path / 'out.ckpt').exists()


def test_reference_files_are_refused_where_port_checkpoints_are_read(
        ref, tmp_path):
    from ab_opt_tpu_torch.train import Trainer
    legacy = str(tmp_path / 'legacy.pt')
    with easydict_standin() as EasyDict:
        torch.save({'config': EasyDict(CONFIG),
                    'model': ref['model'].state_dict(), 'iteration': 5},
                   legacy, _use_new_zipfile_serialization=False)
    bare = str(tmp_path / 'bare.pt')
    torch.save(ref['model'].state_dict(), bare)
    for path in (ref['src'], legacy, bare):
        with pytest.raises(ValueError, match=CONVERTER):
            read_weights(path)
        with pytest.raises(ValueError, match=CONVERTER):
            TD.load_model_from_checkpoint(path)
    trainer = Trainer(TD.random_model(MODEL_CFG, seed=0), {'batch_size': 1},
                      device='cpu')
    for finetune in (True, False):
        with pytest.raises(ValueError, match=CONVERTER):
            trainer.resume(ref['src'], finetune=finetune)
    trainer.resume(ref['out']['port'], finetune=True)
    _assert_same_weights(trainer.model.state_dict(), ref['model'].state_dict())
    # The legacy format and a bare state dict read as the JAX script reads
    # them; a port checkpoint still reads.
    r = read_reference_checkpoint(legacy)
    assert (r['config'], r['iteration']) == (CONFIG, 5)
    _assert_same_weights(r['state_dict'], ref['model'].state_dict())
    r = read_reference_checkpoint(bare)
    assert (r['config'], r['iteration']) == ({}, 0)
    assert sorted(r['state_dict']) == sorted(ref['model'].state_dict())
    port = save_checkpoint(str(tmp_path / 'p.ckpt'), config=CONFIG,
                           model=ref['model'].state_dict(), iteration=9)
    assert read_weights(port)['iteration'] == 9


YAML_SOURCE = '''
class YamlDict(dict):
    def __init__(self, d=None):
        super().__init__(d or {})
        object.__setattr__(self, '_root', self)
        object.__setattr__(self, '_recursive', False)

class YamlList(list):
    pass
'''


def test_a_dynamic_yaml_config_reads_with_its_references(tmp_path):
    """The tolerant stand-in for ``dynamic_yaml``'s classes (their pickled
    form is not known here): items, attributes and ``"{a.b}"`` strings."""
    import types
    module = types.ModuleType('dynamic_yaml.yaml_wrappers')
    exec(YAML_SOURCE, module.__dict__)
    D, Ls = module.YamlDict, module.YamlList
    cfg = D({'model': D({'antigen_size': 20, 'type': 'diffab'}),
             'dataset': D({'transform': Ls([D({
                 'type': 'patch_around_anchor',
                 'antigen_size': '{model.antigen_size}'})])})})
    path = str(tmp_path / 'yaml.pt')
    saved = {k: sys.modules.get(k) for k in ('dynamic_yaml',
                                             'dynamic_yaml.yaml_wrappers')}
    sys.modules['dynamic_yaml'] = types.ModuleType('dynamic_yaml')
    sys.modules['dynamic_yaml.yaml_wrappers'] = module
    try:
        torch.save({'config': cfg, 'model': {'w': torch.ones(2)},
                    'iteration': 3}, path)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    r = read_reference_checkpoint(path)
    assert r['config'] == {
        'model': {'antigen_size': 20, 'type': 'diffab'},
        'dataset': {'transform': [{'type': 'patch_around_anchor',
                                   'antigen_size': 20}]}}
    assert type(r['config']['dataset']['transform']) is list


def test_a_design_request_from_the_converted_file_is_the_port_checkpoints(
        ref, tmp_path):
    pdb = write_synthetic_complex(str(tmp_path / 'cx.pdb'), seed=2)
    port = save_checkpoint(str(tmp_path / 'same.ckpt'), config=CONFIG,
                           model=ref['model'].state_dict(), iteration=250000)
    design_cfg = {'mode': 'single_cdr', 'model': MODEL_CFG,
                  'sampling': {'cdrs': ['H_CDR3'], 'sample_structure': True,
                               'sample_sequence': True}}
    for name, ckpt in (('converted', ref['out']['port']), ('port', port)):
        TD.design_for_pdb(TD.DesignArgs(
            pdb_path=pdb, ckpt=ckpt, config=design_cfg, num_samples=3,
            batch_size=2, seed=11, out_root=str(tmp_path / name),
            device='cpu'))
    got, want = _tree(tmp_path / 'converted'), _tree(tmp_path / 'port')
    assert sorted(got) == sorted(want) and len(got) > 6
    for k in want:
        assert got[k] == want[k], k
