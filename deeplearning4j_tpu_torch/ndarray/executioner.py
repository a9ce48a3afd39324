"""TorchExecutioner — the op execution environment.

The counterpart of ``deeplearning4j_tpu/ndarray/executioner.py``
(reference: OpExecutioner, ``XlaExecutioner``, which the port also names).
The reference's jit cache is a capture cache here: ``exec(fn, *args)``
with tensors on the card keeps one ``runtime.aot.CapturedStep`` per
function (FIFO-bounded, keyed on the function's identity: pass a stable
function), which captures each new signature of ``fn`` on first sight as
a CUDA graph and replays it after; the outputs are copied out of the
graph's static buffers, so a result outlives the next call. A function
that cannot be captured (it reads a tensor on the host, its draws take
host seeds) runs eagerly, counted as an uncaptured dispatch. On the CPU,
or with keyword arguments, ``exec`` calls ``fn`` eagerly. The
environment handle (devices, platform, profiling) and ``commit``, the
synchronisation barrier, are as the reference's; with profiling on,
``exec`` times each call to a ``torch.cuda.synchronize`` and prints it.
``static_argnums``/``donate_argnums`` are part of the cache key, as in
the reference, and have nothing else to act on.
"""

from __future__ import annotations

import time

import torch

__all__ = ["TorchExecutioner", "XlaExecutioner"]


def _clone_out(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (list, tuple)):
        return type(out)(_clone_out(o) for o in out)
    if isinstance(out, dict):
        return {k: _clone_out(v) for k, v in out.items()}
    return out


def _on_card(args):
    return any(isinstance(a, torch.Tensor) and a.device.type == "cuda"
               for a in args)


class TorchExecutioner:
    _instance = None

    #: captured functions kept (FIFO)
    _CAPTURE_CACHE_MAX = 256

    def __init__(self):
        self._profiling = False
        self._captures = {}

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
        """Run ``fn(*args, **kw)``: replayed from its capture when the
        arguments are on the card (module docstring), else eagerly; with
        profiling on, print its time to a device synchronize."""
        if not self._profiling:
            return self._run(fn, args, kw, static_argnums, donate_argnums)
        self.commit()
        t0 = time.perf_counter()
        out = self._run(fn, args, kw, static_argnums, donate_argnums)
        self.commit()
        print(f"[TorchExecutioner] {getattr(fn, '__name__', fn)}: "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
        return out

    def _run(self, fn, args, kw, static_argnums, donate_argnums):
        if kw or not _on_card(args):
            return fn(*args, **kw)
        from deeplearning4j_tpu_torch.runtime import aot

        key = (fn, tuple(static_argnums), tuple(donate_argnums))
        cap = self._captures.get(key)
        if cap is None:
            if len(self._captures) >= self._CAPTURE_CACHE_MAX:
                self._captures.pop(next(iter(self._captures)))
            cap = aot.CapturedStep(fn, entry="exec",
                                   fingerprint=repr(key))
            cap.auto = True
            self._captures[key] = cap
        if cap.refusal is None and not cap.captured(args):
            try:
                cap.capture(args)
            except (aot.CaptureRefused, RuntimeError) as e:
                cap.refusal = f"exec: {e}"
        if cap.refusal is not None:
            return cap._eager(args, {}, "refused")
        return _clone_out(cap(*args))

    def commit(self) -> None:
        """Synchronisation barrier (reference: stream sync / flushQueue)."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()


#: the reference's name for the executioner
XlaExecutioner = TorchExecutioner
