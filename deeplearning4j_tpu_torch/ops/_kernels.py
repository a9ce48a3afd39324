"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, under
``_build/`` inside the package (git-ignored), keyed by a hash of the
source so an edited kernel is rebuilt and a built one is reused. The
``nvcc`` processes of all sources are started together and waited for
together, so the build takes as long as the slowest file. The libraries
are loaded with ``ctypes``: every pointer and the stream are
``c_void_p``, ints are ``c_int``. Each C entry point returns
``cudaGetLastError()`` after its launch; ``check`` raises when that is
not 0.

``count_launch`` is where a wrapper counts its kernel's launch. On a
stream that a CUDA graph is capturing nothing ran: the launch goes to
that capture's tally (``capture_tally``), whichever thread made it (the
backward runs on autograd's worker thread, on the forward's stream),
and the graph adds it back at every replay (``add_launches``). A launch
on another stream while a graph captures is counted as it happens.

Nothing here runs at import: CPU-only test runs import every module
and have no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["library", "check", "count_launch", "add_launches",
           "capture_tally", "SOURCES", "BUILD_SECONDS"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
BUILD_DIR = _PKG / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signature of each entry point (restype c_int: a cudaError_t)
_SIGNATURES = {
    # pointers (the fp32 workspace among them), S H Dh page MP, scale,
    # stream
    "dl4j_paged_decode_f32": [_P] * 8 + [_I] * 5 + [_F, _P],
    "dl4j_paged_decode_bf16": [_P] * 8 + [_I] * 5 + [_F, _P],
    # pointers, C H Dh page MP t0 n_valid, scale, stream
    "dl4j_paged_prefill_f32": [_P] * 6 + [_I] * 7 + [_F, _P],
    "dl4j_paged_prefill_bf16": [_P] * 6 + [_I] * 7 + [_F, _P],
}
for _t in ("f32", "bf16"):
    # pointers, the host stride array, B H Tq Tk D causal, scale, stream
    _SIGNATURES[f"dl4j_flash_fwd_{_t}"] = [_P] * 6 + [_I] * 6 + [_F, _P]
    _SIGNATURES[f"dl4j_flash_bwd_dq_{_t}"] = [_P] * 8 + [_I] * 6 + [_F, _P]
    _SIGNATURES[f"dl4j_flash_bwd_dkv_{_t}"] = [_P] * 9 + [_I] * 6 + [_F, _P]

#: seconds each source took to build in this process (0.0: reused)
BUILD_SECONDS: dict[str, float] = {}

_LOCK = threading.Lock()
_LIB = None


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found at {path}: the CUDA toolkit is needed to "
            "build the port's kernels (set CUDA_HOME)")
    return str(path)


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _nvcc_one(nvcc, src: Path, out: Path):
    """Build one source into `out`; (seconds, error text or None)."""
    t0 = time.perf_counter()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return time.perf_counter() - t0, (
            f"nvcc failed ({res.returncode}) on {src.name}:\n"
            f"{res.stderr[-4000:]}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    return time.perf_counter() - t0, None


def _build_all(sources) -> list[Path]:
    """One nvcc per source not built yet, all running at once."""
    outs = [_target(s) for s in sources]
    todo = [(s, o) for s, o in zip(sources, outs) if not o.exists()]
    for s in sources:
        BUILD_SECONDS[s.name] = 0.0
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            done = list(pool.map(lambda so: _nvcc_one(nvcc, *so), todo))
        failures = []
        for (src, _), (secs, err) in zip(todo, done):
            BUILD_SECONDS[src.name] = secs
            if err is not None:
                failures.append(err)
        if failures:
            raise RuntimeError("\n".join(failures))
    return outs


class _Library:
    """The entry points of every built source, by name."""

    def __init__(self, paths):
        self._libs = [ctypes.CDLL(str(p)) for p in paths]
        for name, argtypes in _SIGNATURES.items():
            fn = next((getattr(lib, name) for lib in self._libs
                       if hasattr(lib, name)), None)
            if fn is None:
                raise RuntimeError(f"no built kernel library exports {name}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


def library():
    """The loaded kernel libraries (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _Library(_build_all(SOURCES))
        return _LIB


def check(err, what):
    """Raise if a launch reported a CUDA error (0 = cudaSuccess)."""
    if err != 0:
        hint = {1: " (no kernel instantiated for this head width)",
                9: " (the tiles need more shared memory than the card "
                   "allows)"}.get(err, "")
        raise RuntimeError(
            f"{what}: CUDA launch failed with cudaError {err}{hint}")


_COUNT_LOCK = threading.Lock()
#: capturing stream's handle -> {wrapper name: launches} of its capture
_TALLIES: dict = {}


def add_launches(fn, n=1):
    """Add `n` to the launch count of the wrapper `fn`."""
    with _COUNT_LOCK:
        fn.launches += n


def count_launch(fn):
    """One launch of the wrapper `fn`'s kernel (module docstring)."""
    import torch

    if torch.cuda.is_current_stream_capturing():
        key = torch.cuda.current_stream().cuda_stream
        with _COUNT_LOCK:
            tally = _TALLIES.get(key)
            if tally is not None:
                tally[fn.__name__] = tally.get(fn.__name__, 0) + 1
        return
    add_launches(fn)


@contextlib.contextmanager
def capture_tally(stream):
    """{wrapper name: launches} recorded on `stream` inside the block,
    while a graph captures on it."""
    key = stream.cuda_stream
    tally = {}
    with _COUNT_LOCK:
        _TALLIES[key] = tally
    try:
        yield tally
    finally:
        with _COUNT_LOCK:
            _TALLIES.pop(key, None)
