"""Run one cell of the benchmark of ``ab_opt_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for (``BENCHMARK.json``). With ``--trace 0`` the last line of
standard output is the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from one ``torch.profiler`` session; either way
with ``correct``, the output check against the plain reference, and each
number compared beside its limit (also the last lines of standard
error). Exits non-zero, printing no result, without the cards, when the
JAX package or JAX is loaded, or when the program is absent."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _environment():
    """Kernel caches at fixed paths inside the checkout; no JAX behind a
    library's back."""
    cache = BENCH / '.cache'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['USE_FLAX'] = '0'
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from harness import guard, manifest, run_cell
    cell = manifest.load_cell(args.workload)
    guard.require_cards(cell.chips)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell.run(cell, args.seed, args.seconds, bool(args.trace),
                          'cuda', T_START)
    found = guard.forbidden_modules()
    if found:
        print(f'benchmark: forbidden modules loaded: {", ".join(found)}',
              file=sys.stderr)
        return 3
    print(f'build_s {result["build_s"]!r}', file=sys.stderr)
    for name, c in result['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
