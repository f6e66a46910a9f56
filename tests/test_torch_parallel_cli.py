"""The training CLI's data-parallel path (``runners/train_cli.py --num_devices``)
on the CPU: gloo ranks spawned by the CLI on a mini-SAbDab of synthetic
complexes (``utils/bench_fixture.py::write_mini_sabdab``), at a tiny
``codesign_single`` (2 layers, narrow widths, 4 diffusion steps, batch 16,
2 steps, val and the sampling eval at step 2):

* ``--num_devices 2 --dist_backend gloo`` returns the losses of every step
  and the val loss that ``--num_devices 1`` returns for the same seed
  (1e-5 relative), its log written by rank 0 alone and its checkpoint the
  one-device run's weights (1e-5);
* the checkpoint it leaves resumes in one process and trains on;
* ``--num_devices 3`` on batch 16 starts 2 ranks, the divisor JAX's
  ``auto_mesh_for_batch`` picks, and says so in the log.
"""
import copy
import os

import numpy as np
import pytest
import torch
import yaml

from ab_opt_tpu_torch.runners import train_cli as TC
from ab_opt_tpu_torch.utils.bench_fixture import write_mini_sabdab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, ITERS = 16, 2


@pytest.fixture(scope='module')
def yml(tmp_path_factory):
    root = tmp_path_factory.mktemp('dp_cli')
    paths = write_mini_sabdab(str(root), n=32)
    cfg = yaml.safe_load(open(os.path.join(REPO, 'configs', 'train',
                                           'codesign_single.yml')))
    cfg['model'].update(res_feat_dim=16, pair_feat_dim=8, num_bins=8)
    cfg['model']['diffusion'].update(num_steps=4,
                                     eps_net_opt={'num_layers': 2})
    cfg['train'].update(max_iters=ITERS, val_freq=ITERS, batch_size=BATCH,
                        sampling_eval={'enabled': True, 'num_items': 2,
                                       'num_samples': 2})
    c = copy.deepcopy(cfg)
    for split in ('train', 'val'):
        c['dataset'][split].update(paths)
        c['dataset'][split]['transform'][-1].update(initial_patch_size=16,
                                                    antigen_size=16)
    path = root / 'tiny.yml'
    path.write_text(yaml.safe_dump(c))
    return root, str(path)


def _run(root, path, name, *flags):
    return TC.main(['--config', path, '--logdir', str(root / name),
                    '--seed', '7', '--device', 'cpu', *flags])


@pytest.fixture(scope='module')
def runs(yml):
    root, path = yml
    return {n: _run(root, path, f'dp{n}', '--num_devices', str(n),
                    *(('--dist_backend', 'gloo') if n > 1 else ()))
            for n in (1, 2)}


def _weights(log_dir, it=ITERS):
    return torch.load(os.path.join(log_dir, 'checkpoints', f'{it}.ckpt'),
                      map_location='cpu', weights_only=True)['model']


def test_ranks_log_the_one_device_losses(runs):
    one, dp = runs[1], runs[2]
    assert dp.ranks == 2 and one.ranks == 1
    assert dp.iteration == one.iteration == ITERS
    assert dp.trainer is None and one.trainer.iteration == ITERS
    assert sorted(dp.losses) == sorted(one.losses)
    for k, want in one.losses.items():
        assert len(want) == ITERS
        np.testing.assert_allclose(dp.losses[k], want, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert sorted(dp.val_losses) == sorted(one.val_losses) == [ITERS]
    np.testing.assert_allclose(dp.val_losses[ITERS], one.val_losses[ITERS],
                               rtol=1e-5)
    a, b = _weights(dp.log_dir), _weights(one.log_dir)
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_rank_zero_owns_the_run(runs):
    dp = runs[2]
    text = open(os.path.join(dp.log_dir, 'train.log')).read()
    assert 'data-parallel: 2 ranks, gloo backend, device cpu' in text
    assert text.count(f'trainer: val it {ITERS} | ') == 1
    ckpts = sorted(os.listdir(os.path.join(dp.log_dir, 'checkpoints')))
    assert f'{ITERS}.ckpt' in ckpts
    assert sum(c.startswith('best_rmsd_') for c in ckpts) == 1
    assert os.path.exists(os.path.join(dp.log_dir, 'sampling_eval',
                                       f'it{ITERS}', 'results.csv'))
    assert not [f for f in os.listdir(dp.log_dir) if 'nan_dump' in f]


def test_fallback_to_a_divisor_of_the_batch(yml, monkeypatch):
    """The ranks' training is the case above: here only the rank count
    the CLI starts and what it logs."""
    root, path = yml
    started = []

    def spawn(fn, nprocs, backend, device, args):
        started.append((nprocs, backend, device))
        return [TC.TrainRun(args[2], 0, nprocs, {}, {})]

    monkeypatch.setattr(TC, 'spawn', spawn)
    run = _run(root, path, 'dp3', '--num_devices', '3', '--dist_backend',
               'gloo')
    assert started == [(2, 'gloo', 'cpu')] and run.ranks == 2
    text = open(os.path.join(run.log_dir, 'train.log')).read()
    assert '--num_devices 3 does not divide batch 16: training on 2 ranks' \
        in text


def test_dp_checkpoint_resumes_in_one_process(runs, yml):
    root, path = yml
    ckpt = os.path.join(runs[2].log_dir, 'checkpoints', f'{ITERS}.ckpt')
    resumed = TC.main(['--config', path, '--resume', ckpt, '--max_iters',
                       str(ITERS + 1), '--seed', '7', '--device', 'cpu'])
    assert resumed.log_dir == runs[2].log_dir
    assert resumed.iteration == ITERS + 1 and resumed.ranks == 1
    assert all(len(v) == 1 and np.isfinite(v[0])
               for v in resumed.losses.values())
