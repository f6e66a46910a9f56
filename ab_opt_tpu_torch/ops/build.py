"""Build the port's CUDA kernels: each ``csrc/*.cu`` is compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface under
``_build/`` (keyed by the hash of the source and of every ``csrc/*.cuh``
header, so an unchanged source is not rebuilt and a changed header rebuilds
every source) and loaded with ``ctypes``. Builds happen at first use, never
at import."""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / 'csrc'
BUILD_DIR = _PKG_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def nvcc_path() -> str:
    path = shutil.which('nvcc')
    if path is None:
        cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
        path = os.path.join(cuda_home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError(
            f'nvcc not found: the kernels in {CSRC_DIR} are compiled at first '
            'use and need the CUDA toolkit')
    return path


def library_path(src: Path, build_dir: Path, flags=()) -> Path:
    """Where ``src`` built with ``flags`` lives: named by a digest of the
    source, the headers beside it (all of them: a source that includes none
    is rebuilt for nothing, never loaded stale) and the nvcc command."""
    h = hashlib.sha256(Path(src).read_bytes())
    for header in sorted(Path(src).parent.glob('*.cuh')):
        h.update(header.name.encode() + header.read_bytes())
    h.update(' '.join(NVCC_FLAGS + tuple(flags)).encode())
    digest = h.hexdigest()
    return Path(build_dir) / f'{Path(src).stem}-{digest[:16]}.so'


def build_sources(sources, build_dir: Path = BUILD_DIR, flags=()) -> dict:
    """Compile every source that is not built yet, one ``nvcc`` per source,
    all started together; ``flags`` are added to every command (a profiling
    build's defines). Returns ``{str(src): {'path', 'seconds', 'log'}}``
    (seconds 0 and an empty log for a library that was already built);
    raises with nvcc's output if any compile fails."""
    results, running = {}, []
    t0 = time.perf_counter()
    for src in sources:
        lib = library_path(src, build_dir, flags)
        if lib.exists():
            results[str(src)] = {'path': str(lib), 'seconds': 0.0, 'log': ''}
            continue
        nvcc = nvcc_path()
        Path(build_dir).mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=build_dir)
        os.close(fd)
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, *flags, '-o', tmp,
                                 str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in running:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f'{src}: nvcc failed ({proc.returncode}):\n{log}')
            continue
        os.replace(tmp, lib)
        results[str(src)] = {'path': str(lib), 'log': log,
                             'seconds': time.perf_counter() - t0}
    if failed:
        raise RuntimeError('\n'.join(failed))
    return results


def build_all(build_dir: Path = BUILD_DIR) -> dict:
    """Build every kernel source of the port (``csrc/*.cu``) in parallel."""
    return build_sources(sorted(CSRC_DIR.glob('*.cu')), build_dir)
