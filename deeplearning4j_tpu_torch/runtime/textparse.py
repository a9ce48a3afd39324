"""ctypes binding for the native bulk CSV parser (``csrc/textparse.cpp``).

The counterpart of ``deeplearning4j_tpu/runtime/textparse.py``, built by
``runtime/_native.py`` as the ring is. ``parse_csv_f32`` returns None
where the content is not the parser's to serve: a delimiter it cannot
handle (whitespace, more than one character) or text that is not a clean
numeric rectangle (ragged rows, non-numeric or empty fields). The caller
then reads the file through the Python record loop, with its richer
per-token semantics; that is behaviour, the same as the reference's.
Where the reference also returns None when the library cannot be built,
this one raises (``NativeLoader.lib``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from deeplearning4j_tpu_torch.runtime._native import NativeLoader

__all__ = ["parse_csv_f32", "native_lib"]


def _configure(lib):
    lib.tp_parse_f32.restype = ctypes.c_long
    lib.tp_parse_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char,
        ctypes.c_long, ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.POINTER(ctypes.c_long)]


_loader = NativeLoader("textparse.cpp", _configure)


def native_lib():
    """The native parser, built on first use; raises when it cannot be
    built."""
    return _loader.lib()


def _first_data_line(data, skip_rows):
    """First non-blank, non-skipped line, without copying the buffer."""
    i, skipped, n = 0, 0, len(data)
    while i < n:
        j = data.find(b"\n", i)
        if j < 0:
            j = n
        line = data[i:j].strip()
        i = j + 1
        if not line:
            continue
        if skipped < int(skip_rows):
            skipped += 1
            continue
        return line
    return b""


def parse_csv_f32(data, delimiter=",", skip_rows=0):
    """bytes/str -> float32 [rows, cols] matrix, or None where the
    content is the Python record loop's (module docstring)."""
    lib = native_lib()
    if isinstance(data, str):
        data = data.encode("utf-8")
    d = str(delimiter)
    # whitespace delimiters collide with the parser's field trimming
    if len(d) != 1 or d in (" ", "\t", "\n", "\r"):
        return None
    # capacity: rows over-estimated from the newline count (headers and
    # blank lines inflate it harmlessly), columns from the first DATA
    # line, so a short header row cannot shrink the estimate
    first = _first_data_line(data, skip_rows)
    if not first:
        return None
    cols_est = first.count(d.encode()) + 1
    cap = (data.count(b"\n") + 1) * cols_est
    out = np.empty(cap, np.float32)
    ncols = ctypes.c_long(0)
    rows = lib.tp_parse_f32(
        data, len(data), d.encode()[0], int(skip_rows),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap, ctypes.byref(ncols))
    if rows <= 0 or ncols.value == 0:
        return None
    return out[:rows * ncols.value].reshape(rows, ncols.value).copy()
