"""``BENCHMARK.json`` and the files it names, found by name.

A cell is one entry of ``workloads``: a configuration
(``configs/<config>.json``), a traffic mix (``traffic/<traffic>.json``),
the limits of its output check (``limits/<cell>.json``), its end-to-end
metrics (those whose ``workloads`` list it, or that list none) and its
per-layer metrics, each read by ``metrics/<name>.py``. Adding a cell, a
configuration or a metric adds files and entries; it edits none."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = BENCH_DIR.parent
MANIFEST = REPO_ROOT / 'BENCHMARK.json'


@dataclasses.dataclass
class Cell:
    """Everything one run of a cell reads."""
    name: str
    chips: int
    config: Dict            # the configuration file's JSON
    traffic: Dict           # the traffic file's JSON
    limits: Dict            # number name -> limit of the output check
    end_to_end: List[Dict]  # manifest entries reported with --trace 0
    per_layer: List[Dict]   # manifest entries reported with --trace 1


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(entries: List[Dict], cell: str) -> List[Dict]:
    return [m for m in entries if cell in m.get('workloads', [cell])]


def load_cell(name: str, manifest: Optional[Dict] = None,
              root: Path = REPO_ROOT) -> Cell:
    """The cell ``name`` of the manifest, with its files read."""
    manifest = manifest or load_json(root / 'BENCHMARK.json')
    cells = {w['name']: w for w in manifest['workloads']}
    if name not in cells:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json '
                       f'(has {", ".join(sorted(cells))})')
    w = cells[name]
    configs = {c['name']: c for c in manifest['configs']}
    bench = root / 'benchmark'
    limits_path = bench / 'limits' / f'{name}.json'
    return Cell(
        name=name, chips=int(w['chips']),
        config=load_json(root / configs[w['config']]['file']),
        traffic=load_json(bench / 'traffic' / f'{w["traffic"]}.json'),
        limits=load_json(limits_path) if limits_path.exists() else {},
        end_to_end=_for_cell(manifest['end_to_end'], name),
        per_layer=_for_cell(manifest['per_layer'], name))


def metric_reader(name: str, bench: Path = BENCH_DIR) -> Callable:
    """``read(view)`` of ``metrics/<name>.py``: the metric's value from a
    trace view (:class:`harness.trace.TraceView`), or None when the trace
    holds nothing it reads."""
    path = bench / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'benchmark_metric_{name.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
