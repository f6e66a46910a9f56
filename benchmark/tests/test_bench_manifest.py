"""BENCHMARK.json against the benchmark's contract, and the files it
names found by name."""
import json
import re

import pytest

from bench_tiny import BENCH  # noqa: F401  (puts the benchmark on the path)
from harness import manifest

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
ROOT = manifest.REPO_ROOT


@pytest.fixture(scope='module')
def bench():
    with open(ROOT / 'BENCHMARK.json') as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert bench['command'][:2] == ['python3', 'benchmark/run.py']
    assert bench['paths'] == ['benchmark']
    assert 1 <= bench['run_seconds'] <= 51
    # A full check of 24 cells fits its 43200 s.
    runs = 2 + 14 * 24
    assert runs * (bench['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys(bench):
    seen = set()
    for group, keys in (('configs', {'name', 'source', 'file', 'reduced',
                                     'why'}),
                        ('workloads', {'name', 'config', 'traffic', 'chips',
                                       'why'})):
        for e in bench[group]:
            assert set(e) == keys, e
            assert NAME.match(e['name']), e['name']
            assert 1 <= len(e['why']) <= 200 and '\n' not in e['why']
    for e in bench['end_to_end'] + bench['per_layer']:
        assert NAME.match(e['name']) and UNIT.match(e['unit']), e
        assert e['better'] in ('lower', 'higher')
        assert e['name'] not in seen
        seen.add(e['name'])
    for e in bench['end_to_end']:
        assert e['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= e['bound'] <= 0.25
    assert any(e['name'] == 'setup_s' for e in bench['end_to_end'])
    for e in bench['per_layer']:
        assert 1 <= len(e['layer']) <= 200 and '\n' not in e['layer']
        assert e['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_metric_cell_reports_what_it_moves(bench):
    cells = {w['name'] for w in bench['workloads']}
    e2e = {e['name']: set(e.get('workloads', cells))
           for e in bench['end_to_end']}
    for m in bench['per_layer']:
        assert m['moves'] in e2e, m
        for w in m.get('workloads', cells):
            assert w in cells and w in e2e[m['moves']], (m['name'], w)
    for w in cells:
        assert w in e2e['setup_s']
        assert any(w in v for n, v in e2e.items() if n != 'setup_s')
        assert any(w in m.get('workloads', cells) for m in bench['per_layer'])


def test_every_config_has_a_cell_and_its_file(bench):
    used = {w['config'] for w in bench['workloads']}
    files = set()
    for c in bench['configs']:
        assert c['name'] in used
        assert c['file'].startswith('benchmark/') and c['file'] not in files
        files.add(c['file'])
        data = manifest.load_json(ROOT / c['file'])
        assert data['reduced'] == c['reduced']
        assert data['source'] == c['source']
    assert all(w['chips'] == 1 for w in bench['workloads'])


# The numbers each kind of traffic's output check produces.
TRAIN = {'loss_gap', 'grad_gap', 'change_gap', 'change_gap_median'}
NUMBERS = {'sample': {'first_pos_gap_rms_A', 'first_rot_gap_median',
                      'step_eps_gap', 'seq_margin', 'context_changed',
                      'backbone_gap_A'},
           'train': TRAIN | {'window_' + n for n in TRAIN}}


def test_cells_load_by_name(bench):
    for w in bench['workloads']:
        cell = manifest.load_cell(w['name'])
        assert cell.traffic['kind'] in ('sample', 'train')
        assert cell.limits, f'{w["name"]}: no limits file'
        assert set(cell.limits) <= NUMBERS[cell.traffic['kind']], w['name']
        assert {m['name'] for m in cell.end_to_end} >= {'setup_s'}
        for m in cell.per_layer:
            assert callable(manifest.metric_reader(m['name']))
