"""Self-described columnar binary storage for record data.

The counterpart of ``deeplearning4j_tpu/data/columnar.py``, a copy of
its host code: a file written by either package reads in the other, byte
for byte, and the 4 GiB string-offset guard is kept. Reference: datavec-arrow's `ArrowRecordReader`/`ArrowRecordWriter` and
the datavec-hadoop columnar readers — upstream persists schema'd record
batches in a columnar binary layout so readers can scan single columns
without parsing rows. pyarrow is not in this image, so the format here
is a minimal self-described native one (magic ``NDC1``), same role:

    NDC1 | uint32 header_len | JSON header | column blocks...

The JSON header carries the full Schema (name/type/states) plus row
count and per-column encodings, so a reader needs NO side information.
Column blocks, in header order:

    double   -> float64 LE contiguous + uint8 validity
    integer  -> int64 LE contiguous + uint8 validity (missing rows 0)
    categorical/string -> uint32 LE offsets[n+1] + utf-8 blob + validity

Validity is an explicit byte per row (arrow's null bitmap, unpacked —
simplicity over the last 7 bits). Missing values round-trip as None.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from deeplearning4j_tpu_torch.data.records import RecordReader, Schema

_MAGIC = b"NDC1"


def writeColumnar(path, schema: Schema, records):
    """Write records (list of row-lists matching `schema`) to `path`.
    Reference: ArrowRecordWriter.writeBatch."""
    rows = [list(r) for r in records]
    n = len(rows)
    names = schema.getColumnNames()
    for r in rows:
        if len(r) != len(names):
            raise ValueError(
                f"record width {len(r)} != schema width {len(names)}")
    header = {"rows": n, "columns": []}
    blocks = []
    for ci, name in enumerate(names):
        typ = schema.getType(name)
        col = [r[ci] for r in rows]
        valid = np.array([v is not None for v in col], np.uint8)
        if typ in ("double", "integer"):
            if typ == "integer":
                for v in col:  # 1.7 in an int column must not silently
                    # truncate; true ints skip the float round-trip
                    # (float() loses precision above 2**53)
                    if v is None or (isinstance(v, (int, np.integer))
                                     and not isinstance(v, bool)):
                        continue
                    if float(v) != int(v):
                        raise ValueError(
                            f"column {name!r} is integer but got "
                            f"non-integral value {v!r}")
            vals = np.array([0 if v is None else v for v in col],
                            "<f8" if typ == "double" else "<i8")
            blocks.append(vals.tobytes())
        else:  # categorical / string: one encode pass builds blob+offsets
            chunks = [("" if v is None else str(v)).encode("utf-8")
                      for v in col]
            offs = np.zeros(n + 1, "<u4")
            pos = 0
            for i, c in enumerate(chunks):
                pos += len(c)
                if pos > 0xFFFFFFFF:
                    # guard BEFORE the uint32 store: modern numpy raises
                    # an opaque OverflowError here, older numpy silently
                    # wraps and corrupts every later offset
                    raise ValueError(
                        f"column {name!r} utf-8 blob exceeds the NDC1 "
                        f"uint32 offset limit (4 GiB) at row {i}: split "
                        "the records across multiple files (the format "
                        "has no u8-offset escape hatch yet)")
                offs[i + 1] = pos
            blocks.append(offs.tobytes() + b"".join(chunks))
        blocks.append(valid.tobytes())
        header["columns"].append(
            {"name": name, "type": typ, "states": schema.getMeta(name)})
    hjson = json.dumps(header).encode("utf-8")
    with open(path, "wb") as fh:
        fh.write(_MAGIC)
        fh.write(struct.pack("<I", len(hjson)))
        fh.write(hjson)
        for b in blocks:
            fh.write(b)
    return path


class ColumnarRecordReader(RecordReader):
    """Read an NDC1 file as a RecordReader (reference: ArrowRecordReader
    — drop-in wherever a RecordReader goes, e.g.
    RecordReaderDataSetIterator), with a columnar fast path
    (`asColumns()`) that hands back whole numpy columns without a
    per-row Python loop."""

    def __init__(self):
        self._schema = None
        self._cols = None   # name -> (values ndarray/list, valid ndarray)
        self._n = 0
        self._i = 0

    def initialize(self, path):
        with open(path, "rb") as fh:
            if fh.read(4) != _MAGIC:
                raise ValueError(f"{path} is not an NDC1 columnar file")
            (hlen,) = struct.unpack("<I", fh.read(4))
            header = json.loads(fh.read(hlen).decode("utf-8"))
            self._n = int(header["rows"])
            cols = {}
            scols = []
            for c in header["columns"]:
                typ = c["type"]
                if typ in ("double", "integer"):
                    dtype = "<f8" if typ == "double" else "<i8"
                    vals = np.frombuffer(fh.read(8 * self._n), dtype)
                else:
                    offs = np.frombuffer(fh.read(4 * (self._n + 1)), "<u4")
                    blob = fh.read(int(offs[-1]))
                    vals = [blob[offs[i]:offs[i + 1]].decode("utf-8")
                            for i in range(self._n)]
                valid = np.frombuffer(fh.read(self._n), np.uint8)
                cols[c["name"]] = (vals, valid)
                scols.append((c["name"], typ, c.get("states")))
            self._schema = Schema(scols)
            self._cols = cols
        self._i = 0
        return self

    def getSchema(self) -> Schema:
        return self._schema

    def asColumns(self):
        """name -> numpy array or list of str. The columnar fast path:
        no row materialisation. Missing numeric rows read NaN — an
        integer column containing missing values promotes to float64
        (pandas-style), so a missing row can never masquerade as 0."""
        out = {}
        for name in self._schema.getColumnNames():
            vals, valid = self._cols[name]
            if isinstance(vals, np.ndarray):
                if (valid == 0).any():
                    v = vals.astype(np.float64)
                    v[valid == 0] = np.nan
                    out[name] = v
                else:
                    out[name] = vals.copy()
            else:
                out[name] = list(vals)
        return out

    def hasNext(self):
        return self._cols is not None and self._i < self._n

    def next(self):
        i = self._i
        self._i += 1
        row = []
        for name in self._schema.getColumnNames():
            vals, valid = self._cols[name]
            if not valid[i]:
                row.append(None)
            elif isinstance(vals, np.ndarray):
                v = vals[i]
                row.append(float(v) if self._schema.getType(name) == "double"
                           else int(v))
            else:
                row.append(vals[i])
        return row

    def reset(self):
        self._i = 0
