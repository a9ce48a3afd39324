"""TorchExecutioner — the op execution environment.

The counterpart of ``deeplearning4j_tpu/ndarray/executioner.py``
(reference: OpExecutioner). Dispatch is eager: ``exec(fn, *args)`` calls
``fn``, and each torch op in it launches as it is reached. What stays of
the executioner is the environment handle (devices, platform, profiling)
and ``commit``, the synchronisation barrier. With profiling on, ``exec``
times each call to a ``torch.cuda.synchronize`` and prints it. A
whole-graph capture (``torch.compile`` or a CUDA graph) in place of the
reference's jit cache is a later measurement (ROADMAP.md Queue 1 item
13); ``static_argnums``/``donate_argnums`` are accepted for the
reference's signature and have nothing to act on.
"""

from __future__ import annotations

import time

import torch

__all__ = ["TorchExecutioner"]


class TorchExecutioner:
    _instance = None

    def __init__(self):
        self._profiling = False

    @classmethod
    def instance(cls) -> "TorchExecutioner":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    # ----- environment -----------------------------------------------
    def devices(self):
        if torch.cuda.is_available():
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [torch.device("cpu")]

    def deviceCount(self) -> int:
        return len(self.devices())

    def platform(self) -> str:
        return "cuda" if torch.cuda.is_available() else "cpu"

    def enableProfiling(self, flag: bool = True) -> None:
        self._profiling = flag

    # ----- execution --------------------------------------------------
    def exec(self, fn, *args, static_argnums=(), donate_argnums=(), **kw):
        """Run ``fn(*args, **kw)`` eagerly; with profiling on, print its
        time to a device synchronize."""
        if not self._profiling:
            return fn(*args, **kw)
        self.commit()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.commit()
        print(f"[TorchExecutioner] {getattr(fn, '__name__', fn)}: "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
        return out

    def commit(self) -> None:
        """Synchronisation barrier (reference: stream sync / flushQueue)."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
