"""No module of the benchmark imports JAX or the JAX package, compared
by whole top-level names (the port's name begins with the JAX
package's), and the reference imports neither package of the repo."""
import ast

from bench_tiny import BENCH
from harness import guard


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def _sources(root):
    """The benchmark's own files (not its gitignored ``.cache``)."""
    return [p for p in root.rglob('*.py')
            if not p.relative_to(BENCH).parts[0].startswith('.')]


def test_no_jax_anywhere_in_the_benchmark():
    for path in _sources(BENCH):
        tops = set(_imports(path))
        assert not tops & set(guard.FORBIDDEN), (path, tops)


def test_reference_imports_no_package_of_the_repo():
    for path in _sources(BENCH / 'reference'):
        tops = set(_imports(path))
        assert not tops & {'ab_opt_tpu', 'ab_opt_tpu_torch', 'harness'}, path


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(['ab_opt_tpu_torch.models', 'torch']) == []
    assert guard.forbidden_modules(['ab_opt_tpu.models']) == ['ab_opt_tpu']
    assert guard.forbidden_modules(['jax._src', 'flax']) == ['flax', 'jax']
