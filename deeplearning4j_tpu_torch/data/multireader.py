"""RecordReaderMultiDataSetIterator — multi-input/-output batches from
record readers.

The counterpart of ``deeplearning4j_tpu/data/multireader.py``, a copy of
its host code. Reference: org.deeplearning4j.datasets.datavec
.RecordReaderMultiDataSetIterator (Builder: addReader / addInput /
addOutput / addOutputOneHot) — the standard way to feed a multi-input
ComputationGraph from tabular sources. Readers are materialized
host-side once into column-sliced float matrices (same design as
RecordReaderDataSetIterator), then batching/padding delegates to
MultiDataSetIterator so every batch is fixed-shape.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.data.multidataset import MultiDataSetIterator


class RecordReaderMultiDataSetIterator:
    class Builder:
        def __init__(self, batchSize: int):
            self._batch = int(batchSize)
            self._readers = {}   # name -> RecordReader
            self._specs = []     # (role, reader, kind, args) in call order
            self._sequence = set()  # names added via addSequenceReader

        def addReader(self, name, recordReader):
            if name in self._readers:
                raise ValueError(f"reader {name!r} already added")
            self._readers[name] = recordReader
            return self

        def addSequenceReader(self, name, sequenceReader):
            """A time-series reader (CSVSequenceRecordReader-style:
            next() returns one sequence as a list of per-step rows).
            Specs over it produce [B, C, T] NCW arrays padded to the
            reader's longest sequence, with the matching [B, T] mask
            attached at the spec's position (reference overload:
            RecordReaderMultiDataSetIterator.Builder
            .addSequenceReader)."""
            if name in self._readers:
                raise ValueError(f"reader {name!r} already added")
            self._readers[name] = sequenceReader
            self._sequence.add(name)
            return self

        def _check(self, name):
            if name not in self._readers:
                raise ValueError(
                    f"unknown reader {name!r}; addReader it first "
                    f"(have {sorted(self._readers)})")

        def addInput(self, readerName, columnFirst=None, columnLast=None):
            """All columns when no range is given (reference overload)."""
            self._check(readerName)
            self._specs.append(("input", readerName, "cols",
                                (columnFirst, columnLast)))
            return self

        def addOutput(self, readerName, columnFirst, columnLast):
            self._check(readerName)
            self._specs.append(("output", readerName, "cols",
                                (columnFirst, columnLast)))
            return self

        def addOutputOneHot(self, readerName, column, numClasses):
            self._check(readerName)
            self._specs.append(("output", readerName, "onehot",
                                (int(column), int(numClasses))))
            return self

        def build(self):
            if not any(r == "input" for r, *_ in self._specs):
                raise ValueError("at least one addInput(...) is required")
            if not any(r == "output" for r, *_ in self._specs):
                raise ValueError("at least one addOutput/"
                                 "addOutputOneHot(...) is required")
            return RecordReaderMultiDataSetIterator(
                self._batch, self._readers, self._specs,
                sequence=self._sequence)

    def __init__(self, batchSize, readers, specs, sequence=()):
        from deeplearning4j_tpu_torch.data.records import CSVRecordReader

        sequence = set(sequence)
        records, matrices, seqs = {}, {}, {}
        for name, rr in readers.items():
            if name in sequence:
                rr.reset()
                out = []
                while rr.hasNext():
                    steps = rr.next()
                    if not steps:
                        raise ValueError(
                            f"sequence reader {name!r} produced an "
                            "empty sequence")
                    step_widths = {len(row) for row in steps}
                    if len(step_widths) > 1:
                        raise ValueError(
                            f"ragged sequence in reader {name!r} "
                            f"sequence {len(out)}: step widths "
                            f"{sorted(step_widths)}")
                    try:
                        out.append(np.asarray(
                            [[float(v) for v in row] for row in steps],
                            np.float32))
                    except (TypeError, ValueError):
                        raise ValueError(
                            f"non-numeric value in sequence reader "
                            f"{name!r} sequence {len(out)}")
                seqs[name] = out
                records[name] = None
                continue
            # bulk fast path first: EXACTLY CSVRecordReader (matching
            # RecordReaderDataSetIterator's native-parser contract) can
            # hand over the whole file as one float matrix
            m = rr.asMatrix() if type(rr) is CSVRecordReader else None
            if m is not None and m.ndim == 2:
                matrices[name] = m.astype(np.float32, copy=False)
                records[name] = None
                continue
            rr.reset()
            rows = []
            while rr.hasNext():
                rows.append(rr.next())
            records[name] = rows
        counts = {name: (len(seqs[name]) if name in seqs
                         else len(matrices[name]) if records[name] is None
                         else len(records[name]))
                  for name in readers}
        if len(set(counts.values())) > 1:
            raise ValueError(
                f"readers disagree on record count: {counts} — every "
                "reader must yield one record per example")
        n = next(iter(counts.values()))
        if n == 0:
            raise ValueError("readers produced no records")

        widths = {}
        seq_pack = {}   # name -> (padded [N, width, Tmax], mask [N, Tmax])
        for name in readers:
            if name in seqs:
                ss = seqs[name]
                wset = {a.shape[1] for a in ss}
                if len(wset) > 1:
                    raise ValueError(
                        f"sequence reader {name!r} has inconsistent "
                        f"column counts across sequences: {sorted(wset)}")
                widths[name] = wset.pop()
                tmax = max(a.shape[0] for a in ss)
                packed = np.zeros((len(ss), widths[name], tmax),
                                  np.float32)
                mask = np.zeros((len(ss), tmax), np.float32)
                for i, a in enumerate(ss):
                    packed[i, :, :a.shape[0]] = a.T   # [T,C] -> [C,T]
                    mask[i, :a.shape[0]] = 1.0
                seq_pack[name] = (packed, mask)
            elif records[name] is None:
                widths[name] = matrices[name].shape[1]
            else:
                widths[name] = min(len(r) for r in records[name])
        col_cache = {}

        def get_col(name, c):
            """One column of one reader as float32 — parsed ONCE no
            matter how many specs reference it. Ragged/non-numeric rows
            get row-numbered diagnostics."""
            hit = col_cache.get((name, c))
            if hit is not None:
                return hit
            if records[name] is None:
                out = matrices[name][:, c]
            else:
                # c < widths[name] = min row length (spec validation),
                # so indexing cannot go ragged here
                vals = np.empty(n, np.float32)
                for i, r in enumerate(records[name]):
                    try:
                        vals[i] = float(r[c])
                    except (TypeError, ValueError):
                        raise ValueError(
                            f"non-numeric value {r[c]!r} in reader "
                            f"{name!r} row {i} col {c} — one-hot-encode "
                            "categorical columns with addOutputOneHot "
                            "or transform first")
                out = vals
            col_cache[(name, c)] = out
            return out

        features, labels = [], []
        fmasks, lmasks = [], []
        for role, name, kind, args in specs:
            width = widths[name]
            if name in seq_pack:
                packed, mask = seq_pack[name]
                if kind == "cols":
                    first, last = args
                    first = 0 if first is None else int(first)
                    last = width - 1 if last is None else int(last)
                    if not (0 <= first <= last < width):
                        raise ValueError(
                            f"column range [{first}, {last}] out of "
                            f"bounds for sequence reader {name!r} with "
                            f"{width} columns")
                    arr = packed[:, first:last + 1, :]   # [N, C, T]
                else:  # onehot: per-step labels -> [N, num, T]
                    col, num = args
                    if not 0 <= col < width:
                        raise ValueError(
                            f"one-hot column {col} out of bounds for "
                            f"sequence reader {name!r} ({width} cols)")
                    idx = packed[:, col, :].astype(np.int64)  # [N, T]
                    # padded steps carry 0 — valid class index, masked
                    real = mask > 0
                    vals = idx[real]
                    if vals.size and (vals.min() < 0 or vals.max() >= num):
                        raise ValueError(
                            f"label value {vals.min() if vals.min() < 0 else vals.max()}"
                            f" outside [0, {num}) in sequence reader "
                            f"{name!r} col {col}")
                    arr = np.transpose(
                        np.eye(num, dtype=np.float32)[idx], (0, 2, 1))
                if role == "input":
                    features.append(arr)
                    fmasks.append(mask)
                else:
                    labels.append(arr)
                    lmasks.append(mask)
                continue
            if kind == "cols":
                first, last = args
                first = 0 if first is None else int(first)
                last = width - 1 if last is None else int(last)
                if not (0 <= first <= last < width):
                    raise ValueError(
                        f"column range [{first}, {last}] out of bounds "
                        f"for reader {name!r} with {width} columns "
                        "(shortest row governs)")
                arr = np.stack([get_col(name, c)
                                for c in range(first, last + 1)], axis=1)
            else:  # onehot
                col, num = args
                if not 0 <= col < width:
                    raise ValueError(f"one-hot column {col} out of bounds "
                                     f"for reader {name!r} ({width} cols)")
                idx = get_col(name, col).astype(np.int64)
                if idx.min() < 0 or idx.max() >= num:
                    raise ValueError(
                        f"label value {idx.min() if idx.min() < 0 else idx.max()}"
                        f" outside [0, {num}) in reader {name!r} col {col}")
                arr = np.eye(num, dtype=np.float32)[idx]
            if role == "input":
                features.append(arr)
                fmasks.append(None)
            else:
                labels.append(arr)
                lmasks.append(None)

        self._it = MultiDataSetIterator(
            features, labels, batchSize,
            featuresMasks=fmasks if any(m is not None for m in fmasks)
            else None,
            labelsMasks=lmasks if any(m is not None for m in lmasks)
            else None)
        self._batch = int(batchSize)
        self._n = n

    # ---- iterator protocol (delegates to MultiDataSetIterator) -------
    def hasNext(self):
        return self._it.hasNext()

    def next(self):
        return self._it.next()

    def reset(self):
        self._it.reset()

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()

    def batch(self):
        return self._batch

    def totalExamples(self):
        return self._n
