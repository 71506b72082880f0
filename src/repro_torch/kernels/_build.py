"""Build and bind the hand-written CUDA kernels.

Each `csrc/*.cu` file exposes a plain C launcher
(`int <name>_launch(..., cudaStream_t)` returning `cudaGetLastError()`)
and is compiled by `nvcc` for `sm_90a` into its own shared library, which
is loaded with `ctypes`. No PyTorch header is included, so a source
builds in seconds.

Libraries are built at first use into `.kernel_build/` at the root of
the checkout (listed in `.gitignore`), named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one is reused.
`build()` starts one `nvcc` per missing library, all at once, and waits
for every one of them. A missing `nvcc` or a failed build raises: there
is no other way to run a kernel on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / '.kernel_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
SOURCES = ('pairwise_rank.cu', 'rank_counts.cu', 'wkv_fwd.cu',
           'wkv_bwd.cu')


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found (looked on PATH and in CUDA_HOME or '
                       '/usr/local/cuda); the CUDA kernels cannot be built')


def library_path(source: str) -> Path:
    """Where the shared library of `source` lives once built."""
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes()
                          + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'{src.stem}-{digest}.so'


def build(sources=SOURCES) -> dict:
    """Build every library in `sources` that is not built yet, in
    parallel; returns {source: library path}. Raises on any failure
    with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for s, p in todo.items():
        tmp = p.with_suffix(f'.{os.getpid()}.tmp')
        log = open(p.with_suffix('.log'), 'w')
        procs[s] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / s)],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for s, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, todo[s])
        else:
            failed.append(f'{s} (exit {rc}):\n'
                          + todo[s].with_suffix('.log').read_text())
    if failed:
        raise RuntimeError('kernel build failed: ' + '\n'.join(failed))
    return paths


def build_log(source: str) -> str:
    """The compiler's output (ptxas register and shared-memory report)
    from the build of `source`, or '' when it was not built here."""
    log = library_path(source).with_suffix('.log')
    return log.read_text() if log.exists() else ''


class Kernel:
    """One C launcher of a built library, with its launch count.

    Calling it launches the kernel on the given stream and raises when
    the launch was refused (`cudaGetLastError()` not 0). `launches`
    counts successful launches; it is a plain integer that a caller may
    reset to 0 before the run it wants to observe."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lib = None

    def _load(self):
        if self._fn is None:
            from .platform import on_hopper
            if not on_hopper():
                raise RuntimeError(
                    f'{self.symbol}: the kernels are built for sm_90a and '
                    'need a Hopper GPU (compute capability 9.0)')
            path = build((self.source,))[self.source]
            self._lib = ctypes.CDLL(str(path))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def query(self, symbol: str, *ints) -> list:
        """Call the library's `int symbol(int..., int* out)`, which fills
        `out` with ints describing the kernel (its launch geometry), and
        return them; raises when it returns an error. Not a launch."""
        self._load()
        out = (ctypes.c_int * 8)()
        fn = getattr(self._lib, symbol)
        fn.argtypes = [INT] * len(ints) + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        err = fn(*ints, out)
        if err != 0:
            raise RuntimeError(f'{symbol}{ints}: error {err}')
        return list(out)

    def __call__(self, *args) -> None:
        err = self._load()(*args)
        if err != 0:
            raise RuntimeError(f'{self.symbol}: CUDA launch failed with '
                               f'error {err}')
        self.launches += 1


PTR = ctypes.c_void_p
INT = ctypes.c_int
