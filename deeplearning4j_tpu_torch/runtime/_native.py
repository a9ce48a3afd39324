"""Build-on-first-use loader for the port's native host libraries.

The counterpart of ``deeplearning4j_tpu/runtime/_native.py``, serving
``runtime/ringbuffer.py`` (``csrc/prefetch.cpp``) and
``runtime/textparse.py`` (``csrc/textparse.cpp``). Each source is
compiled with ``g++`` into the git-ignored ``_build/`` inside the
package, keyed by a hash of the source (as ``ops/_kernels.py`` keys its
``.cu`` builds), so an edited source is rebuilt and a built one reused;
the library is written under a temporary name and renamed into place,
so two processes building at once never load a half-written file.

Where the reference's loader returns ``None`` when it cannot build (and
its callers then quietly take a Python path), this one raises: a missing
compiler or a failed build raises ``RuntimeError`` with the compiler's
error output, and the error is recorded so later calls raise the same
error without probing again. A caller that wants the Python ring asks
for it (``make_ring(..., force_python=True)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NativeLoader", "CSRC", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"


class NativeLoader:
    """One native library: `source` (a file in ``csrc/``) built with
    g++ on first use; ``configure(lib)`` sets restype/argtypes after the
    load."""

    def __init__(self, source, configure, extra_flags=(), compiler="g++"):
        self.src = CSRC / source
        self._configure = configure
        self._flags = list(extra_flags)
        self.compiler = compiler
        self._lib = None
        self._err = None
        self._lock = threading.Lock()

    def target(self) -> Path:
        digest = hashlib.sha256(self.src.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"{self.src.stem}-{digest}.so"

    def _build(self, out: Path):
        cxx = shutil.which(self.compiler)
        if cxx is None:
            raise RuntimeError(
                f"{self.compiler!r} not found: a C++ compiler is needed to "
                f"build {self.src.name} (the Python ring is "
                "make_ring(..., force_python=True))")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, "-O2", "-shared", "-fPIC", "-std=c++17", *self._flags,
               str(self.src), "-o", str(tmp)]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{self.compiler} failed ({res.returncode}) on "
                f"{self.src.name}:\n{res.stderr[-4000:]}")
        os.replace(tmp, out)   # atomic: concurrent builders race safely

    def lib(self):
        """The loaded library; raises the build's error (recorded once)."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            if self._err is not None:
                raise self._err
            try:
                out = self.target()
                if not out.exists():
                    self._build(out)
                lib = ctypes.CDLL(str(out))
                self._configure(lib)
                self._lib = lib
            except Exception as e:
                self._err = e if isinstance(e, RuntimeError) else \
                    RuntimeError(f"native {self.src.name}: {e!r}")
                raise self._err from e
            return self._lib
