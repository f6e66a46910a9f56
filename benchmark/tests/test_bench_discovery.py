"""A cell, a configuration and a metric are added by new files and
manifest entries alone: the harness finds them by name."""
import json
import shutil

from bench_tiny import BENCH
from harness import manifest


def test_new_cell_config_and_metric_found_by_name(tmp_path):
    root = tmp_path / 'repo'
    shutil.copytree(BENCH, root / 'benchmark',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    bench = manifest.load_json(manifest.MANIFEST)
    b = root / 'benchmark'
    (b / 'configs' / 'new-config.json').write_text(json.dumps(
        {'source': 's', 'model': {'type': 'diffab'}, 'reduced': []}))
    (b / 'traffic' / 'new-mix.json').write_text(json.dumps(
        {'kind': 'sample', 'fan_out': 2}))
    (b / 'limits' / 'new-cell.json').write_text(json.dumps({'x': 1.0}))
    (b / 'metrics' / 'new.metric_pct.py').write_text(
        'def read(view):\n    return 42.0\n')
    bench['configs'].append({'name': 'new-config', 'source': 's',
                             'file': 'benchmark/configs/new-config.json',
                             'reduced': [], 'why': 'w'})
    bench['workloads'].append({'name': 'new-cell', 'config': 'new-config',
                               'traffic': 'new-mix', 'chips': 1, 'why': 'w'})
    bench['per_layer'].append({'name': 'new.metric_pct', 'unit': '%',
                               'better': 'higher', 'source': 'device_trace',
                               'layer': 'l', 'moves': 'samples_per_s',
                               'workloads': ['new-cell']})
    bench['end_to_end'][0]['workloads'].append('new-cell')
    cell = manifest.load_cell('new-cell', bench, root)
    assert cell.config['model'] == {'type': 'diffab'}
    assert cell.traffic == {'kind': 'sample', 'fan_out': 2}
    assert cell.limits == {'x': 1.0}
    assert [m['name'] for m in cell.per_layer] == ['new.metric_pct']
    assert manifest.metric_reader('new.metric_pct', b)(None) == 42.0
    assert {m['name'] for m in cell.end_to_end} == {'samples_per_s',
                                                    'setup_s'}
