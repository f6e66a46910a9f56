"""The output check's control on the card (marker ``cuda``; skips
without one): the float32 graph model's control is TF32, which only the
card computes. Run on a machine with a card:

    python -m pytest -q benchmark/tests/test_bench_card.py
"""
import pytest
import torch

import bench_tiny
from harness import run_cell

SEED = 2 ** 33 + 5


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: TF32 exists only on the card')
    return 'cuda'


@pytest.mark.cuda
@pytest.mark.parametrize('kind,model', [('train', 'gnn'), ('train', 'diffab'),
                                        ('sample', 'diffab')])
def test_control_fails_on_card(card, kind, model):
    cell = bench_tiny.cell(kind, model)
    # Wider than the tiny cell's widths so that TF32's rounding shows.
    cell.config['model'].update(
        {'res_feat_dim': 128, 'hidden_size': 128, 'edge_feat_dim': 128}
        if model == 'gnn' else {'res_feat_dim': 128, 'pair_feat_dim': 64})
    driver = run_cell.DRIVERS[kind](cell, SEED, card)
    driver.setup()
    driver.window(0.2)
    driver.release()
    sound = driver.check()
    if kind == 'train':
        low = driver.check(control=True, tf32=True)
    else:
        from harness.reference_run import round_fp8
        low = driver.check(rounding=round_fp8, control=True)
    assert any(low[n] >= 3 * max(sound[n], 1e-12) for n in low), (sound, low)
