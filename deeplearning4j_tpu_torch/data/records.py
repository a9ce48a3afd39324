"""Record readers and transform pipelines (the DataVec layer).

The counterpart of ``deeplearning4j_tpu/data/records.py``, a copy of its
host code (reference: datavec-api CSVRecordReader,
CollectionRecordReader, ImageRecordReader, Schema, TransformProcess, and
deeplearning4j-datavec-iterators RecordReaderDataSetIterator). ETL runs
on the host in numpy; the network sees only the final fixed-shape float
batches. ``TransformProcess.toJson`` writes the reference's JSON through
the port's ``util.serde``, so a pipeline saved by either package loads in
the other. ``CSVRecordReader.asMatrix`` goes through the native parser
(``runtime/textparse.py``), which raises when it cannot be built.
"""

from __future__ import annotations

import operator
import os
from pathlib import Path

import numpy as np


# ----------------------------------------------------------- record readers
class RecordReader:
    def hasNext(self) -> bool:
        raise NotImplementedError

    def next(self) -> list:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()


class CollectionRecordReader(RecordReader):
    """In-memory records (reference: CollectionRecordReader)."""

    def __init__(self, records):
        self._records = [list(r) for r in records]
        self._i = 0

    def hasNext(self):
        return self._i < len(self._records)

    def next(self):
        r = self._records[self._i]
        self._i += 1
        return r

    def reset(self):
        self._i = 0


class CSVRecordReader(RecordReader):
    """Line-per-record CSV (reference: CSVRecordReader). Values come back as
    parsed floats where possible, else strings."""

    def __init__(self, skipNumLines: int = 0, delimiter: str = ","):
        self._skip = skipNumLines
        self._delim = delimiter
        self._lines = None
        self._path = None
        self._i = 0

    def initialize(self, path):
        text = Path(path).read_text()
        lines = [ln for ln in text.splitlines() if ln.strip()]
        self._lines = lines[self._skip:]
        self._path = str(path)
        try:
            st = os.stat(self._path)
            self._stat = (st.st_size, st.st_mtime_ns)
        except OSError:
            self._stat = None
        self._i = 0
        return self

    def asMatrix(self):
        """Whole file as a float32 [rows, cols] matrix via the native
        bulk parser (runtime/textparse.cpp — one buffer sweep instead of
        a per-token Python loop), or None when the content is not a
        clean numeric rectangle (a parser that cannot be built raises). Callers
        (RecordReaderDataSetIterator) fall back to next()-loop
        semantics on None, so mixed-type CSVs behave exactly as before.

        Reads the file lazily (raw text is not kept resident); if the
        file was deleted or changed since initialize(), returns None so
        the caller serves the CACHED lines — next()-loop and fast path
        always see the same data."""
        if self._path is None:
            return None
        try:
            with open(self._path, "rb") as f:
                data = f.read()
                # fstat AFTER the read, on the open fd: stat-then-read
                # would race a concurrent rewrite between the two calls
                st = os.fstat(f.fileno())
            if self._stat != (st.st_size, st.st_mtime_ns):
                return None
        except OSError:
            return None
        from deeplearning4j_tpu_torch.runtime.textparse import parse_csv_f32

        return parse_csv_f32(data, self._delim, self._skip)

    @staticmethod
    def _parse(tok: str):
        tok = tok.strip()
        try:
            return float(tok) if ("." in tok or "e" in tok.lower()) else int(tok)
        except ValueError:
            return tok

    def hasNext(self):
        return self._lines is not None and self._i < len(self._lines)

    def next(self):
        vals = [self._parse(t) for t in self._lines[self._i].split(self._delim)]
        self._i += 1
        return vals

    def reset(self):
        self._i = 0


class ImageRecordReader(RecordReader):
    """Images from a labelled directory tree (reference: ImageRecordReader
    with ParentPathLabelGenerator): ``root/<label>/<file>.png`` ->
    record ``[CHW float array, labelIndex]``."""

    arrayRecords = True  # record = [array, labelIndex]
    EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".gif"}

    def __init__(self, height: int, width: int, channels: int = 3):
        self._h, self._w, self._c = height, width, channels
        self._files = []
        self._labels = []
        self._i = 0

    def initialize(self, root):
        root = Path(root)
        classes = sorted(d.name for d in root.iterdir() if d.is_dir())
        self._label_names = classes
        self._files = []
        for ci, cname in enumerate(classes):
            for f in sorted((root / cname).iterdir()):
                if f.suffix.lower() in self.EXTS:
                    self._files.append((f, ci))
        self._i = 0
        return self

    def getLabels(self):
        return list(self._label_names)

    def numLabels(self) -> int:
        return len(self._label_names)

    def hasNext(self):
        return self._i < len(self._files)

    def next(self):
        from PIL import Image

        path, label = self._files[self._i]
        self._i += 1
        img = Image.open(path)
        img = img.convert("L" if self._c == 1 else "RGB")
        img = img.resize((self._w, self._h))
        a = np.asarray(img, np.float32)
        a = a[None, :, :] if self._c == 1 else a.transpose(2, 0, 1)  # CHW
        return [a, label]

    def reset(self):
        self._i = 0


# ------------------------------------------------------ schema + transforms
def _ieee_div(a, b):
    """IEEE-754 division matching the reference's Java double semantics:
    x/0.0 = ±Infinity, 0.0/0.0 = NaN — a zero divisor must not abort the
    whole pipeline like Python's ZeroDivisionError would."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float64(a) / np.float64(b))


_MATH_OPS = {"Add": operator.add, "Subtract": operator.sub,
             "Multiply": operator.mul, "Divide": _ieee_div}


class Schema:
    """Column schema (reference: org.datavec.api.transform.schema.Schema)."""

    class Builder:
        def __init__(self):
            self._cols = []  # (name, kind, meta)

        def addColumnDouble(self, name):
            self._cols.append((name, "double", None))
            return self

        def addColumnsDouble(self, *names):
            for n in names:
                self.addColumnDouble(n)
            return self

        def addColumnInteger(self, name):
            self._cols.append((name, "integer", None))
            return self

        def addColumnCategorical(self, name, *stateNames):
            if len(stateNames) == 1 and isinstance(stateNames[0], (list, tuple)):
                stateNames = tuple(stateNames[0])
            self._cols.append((name, "categorical", list(stateNames)))
            return self

        def addColumnString(self, name):
            self._cols.append((name, "string", None))
            return self

        def build(self):
            return Schema(self._cols)

    def __init__(self, cols):
        self._cols = list(cols)

    def getColumnNames(self):
        return [c[0] for c in self._cols]

    def getIndexOfColumn(self, name) -> int:
        return self.getColumnNames().index(name)

    def getType(self, name) -> str:
        return self._cols[self.getIndexOfColumn(name)][1]

    def getMeta(self, name):
        return self._cols[self.getIndexOfColumn(name)][2]

    def numColumns(self) -> int:
        return len(self._cols)


class TransformProcess:
    """Declarative record transform pipeline (reference:
    org.datavec.api.transform.TransformProcess). Each step maps
    (schema, records) -> (schema, records); ``execute`` applies the chain."""

    class Builder:
        def __init__(self, schema: Schema):
            self._initial = schema
            self._steps = []
            # declarative call log for toJson/fromJson — filled
            # automatically by the method wrapper installed below the
            # class body; steps it cannot represent (raw-callable
            # filters) land in _unserializable and make toJson raise
            self._spec = []
            self._unserializable = []

        def removeColumns(self, *names):
            def step(schema, recs):
                drop = {schema.getIndexOfColumn(n) for n in names}
                keep = [i for i in range(schema.numColumns()) if i not in drop]
                new = Schema([schema._cols[i] for i in keep])
                return new, [[r[i] for i in keep] for r in recs]
            self._steps.append(step)
            return self

        def renameColumn(self, old, new):
            def step(schema, recs):
                cols = [(new if n == old else n, k, m) for n, k, m in schema._cols]
                return Schema(cols), recs
            self._steps.append(step)
            return self

        def categoricalToInteger(self, *names):
            def step(schema, recs):
                cols = list(schema._cols)
                for n in names:
                    i = schema.getIndexOfColumn(n)
                    states = schema.getMeta(n)
                    for r in recs:
                        r[i] = states.index(r[i])
                    cols[i] = (n, "integer", None)
                return Schema(cols), recs
            self._steps.append(step)
            return self

        def categoricalToOneHot(self, *names):
            def step(schema, recs):
                for n in names:
                    i = schema.getIndexOfColumn(n)
                    states = schema.getMeta(n)
                    cols = list(schema._cols)
                    onehot_cols = [(f"{n}[{s}]", "integer", None) for s in states]
                    cols[i:i + 1] = onehot_cols
                    for r in recs:
                        if r[i] not in states:  # consistent with ToInteger
                            raise ValueError(f"categoricalToOneHot: value "
                                             f"{r[i]!r} not in states {states}")
                        vec = [1 if r[i] == s else 0 for s in states]
                        r[i:i + 1] = vec
                    schema = Schema(cols)
                return schema, recs
            self._steps.append(step)
            return self

        def doubleMathOp(self, name, op: str, value: float):
            fn = _MATH_OPS[op]

            def step(schema, recs):
                i = schema.getIndexOfColumn(name)
                for r in recs:
                    r[i] = fn(float(r[i]), value)
                return schema, recs
            self._steps.append(step)
            return self

        def filter(self, predicate):
            """Keep records where predicate(record_dict) is False (the
            reference's Filter removes matching examples)."""
            def step(schema, recs):
                names = schema.getColumnNames()
                kept = [r for r in recs
                        if not predicate(dict(zip(names, r)))]
                return schema, kept
            self._steps.append(step)
            return self

        def stringToCategorical(self, name, stateNames):
            """Reference: StringToCategoricalTransform — retype a string
            column, validating every value against the states."""
            states = list(stateNames)

            def step(schema, recs):
                i = schema.getIndexOfColumn(name)
                for r in recs:
                    if r[i] not in states:
                        raise ValueError(
                            f"stringToCategorical: value {r[i]!r} in "
                            f"column '{name}' not in states {states}")
                cols = list(schema._cols)
                cols[i] = (name, "categorical", states)
                return Schema(cols), recs
            self._steps.append(step)
            return self

        def integerToCategorical(self, name, stateNames):
            """Reference: IntegerToCategoricalTransform — value k becomes
            stateNames[k]."""
            states = list(stateNames)

            def step(schema, recs):
                i = schema.getIndexOfColumn(name)
                for r in recs:
                    k = int(r[i])
                    if not (0 <= k < len(states)):
                        raise ValueError(
                            f"integerToCategorical: value {k} in column "
                            f"'{name}' outside [0,{len(states)})")
                    r[i] = states[k]
                cols = list(schema._cols)
                cols[i] = (name, "categorical", states)
                return Schema(cols), recs
            self._steps.append(step)
            return self

        def stringMapTransform(self, name, mapping):
            """Reference: StringMapTransform — replace listed values,
            pass others through."""
            mapping = dict(mapping)

            def step(schema, recs):
                i = schema.getIndexOfColumn(name)
                for r in recs:
                    r[i] = mapping.get(r[i], r[i])
                return schema, recs
            self._steps.append(step)
            return self

        def appendStringColumnTransform(self, name, toAppend):
            """Reference: AppendStringColumnTransform."""
            def step(schema, recs):
                i = schema.getIndexOfColumn(name)
                for r in recs:
                    r[i] = str(r[i]) + toAppend
                return schema, recs
            self._steps.append(step)
            return self

        def conditionalReplaceValueTransform(self, name, newValue,
                                             condition):
            """Reference: ConditionalReplaceValueTransform — where the
            condition (data.transform ColumnCondition or any
            record-dict predicate) matches, replace the column value."""
            def step(schema, recs):
                i = schema.getIndexOfColumn(name)
                names = schema.getColumnNames()
                pred = getattr(condition, "condition", condition)
                for r in recs:
                    if pred(dict(zip(names, r))):
                        r[i] = newValue
                return schema, recs
            self._steps.append(step)
            return self

        def replaceMissingWithValue(self, name, value):
            """Missing = None, NaN, or the empty string (reference: the
            ReplaceInvalid / ReplaceEmpty family; "" is what
            CSVRecordReader yields for an absent field)."""
            def step(schema, recs):
                i = schema.getIndexOfColumn(name)
                for r in recs:
                    v = r[i]
                    if v is None or v == "" or \
                            (isinstance(v, float) and v != v):
                        r[i] = value
                return schema, recs
            self._steps.append(step)
            return self

        def doubleColumnsMathOp(self, newName, op, *columns):
            """Reference: DoubleColumnsMathOpTransform — NEW column from
            an op over existing double columns (Add/Subtract/Multiply/
            Divide fold left-to-right; Divide follows Java double
            semantics: x/0.0 = ±Infinity, 0.0/0.0 = NaN)."""
            fn = _MATH_OPS[op]

            def step(schema, recs):
                idx = [schema.getIndexOfColumn(c) for c in columns]
                for r in recs:
                    acc = float(r[idx[0]])
                    for i in idx[1:]:
                        acc = fn(acc, float(r[i]))
                    r.append(acc)
                return Schema(schema._cols + [(newName, "double", None)]), recs
            self._steps.append(step)
            return self

        def addConstantColumn(self, name, kind, value):
            """Reference: AddConstantColumnTransform."""
            def step(schema, recs):
                for r in recs:
                    r.append(value)
                return Schema(schema._cols + [(name, kind, None)]), recs
            self._steps.append(step)
            return self

        def duplicateColumn(self, name, newName):
            """Reference: DuplicateColumnsTransform."""
            def step(schema, recs):
                i = schema.getIndexOfColumn(name)
                kind, meta = schema._cols[i][1], schema._cols[i][2]
                for r in recs:
                    r.append(r[i])
                return Schema(schema._cols + [(newName, kind, meta)]), recs
            self._steps.append(step)
            return self

        def reorderColumns(self, *names):
            """Reference: ReorderColumnsTransform — listed columns first
            (in order), unlisted keep their relative order after."""
            def step(schema, recs):
                all_names = schema.getColumnNames()
                missing = [n for n in names if n not in all_names]
                if missing:
                    raise ValueError(f"reorderColumns: unknown {missing}")
                order = [all_names.index(n) for n in names] + \
                    [i for i, n in enumerate(all_names) if n not in names]
                new = Schema([schema._cols[i] for i in order])
                return new, [[r[i] for i in order] for r in recs]
            self._steps.append(step)
            return self

        def removeAllColumnsExceptFor(self, *names):
            """Reference: TransformProcess.Builder
            .removeAllColumnsExceptFor."""
            def step(schema, recs):
                all_names = schema.getColumnNames()
                missing = [n for n in names if n not in all_names]
                if missing:  # a typo here would silently drop EVERYTHING
                    raise ValueError(
                        f"removeAllColumnsExceptFor: unknown {missing} "
                        f"(schema has {all_names})")
                keep = [i for i, n in enumerate(all_names) if n in names]
                new = Schema([schema._cols[i] for i in keep])
                return new, [[r[i] for i in keep] for r in recs]
            self._steps.append(step)
            return self

        def coordinatesDistanceTransform(self, newColumnName, firstColumn,
                                         secondColumn, delimiter=","):
            """Reference: org.datavec.api.transform.geo
            .CoordinatesDistanceTransform — euclidean distance between
            two delimited-coordinate string columns ("x,y[,z...]"),
            appended as a new double column. Dimensions must agree
            per-row; either side missing/blank yields None."""
            def step(schema, recs):
                i = schema.getIndexOfColumn(firstColumn)
                j = schema.getIndexOfColumn(secondColumn)
                for r in recs:
                    a, b = r[i], r[j]
                    if a in (None, "") or b in (None, ""):
                        r.append(None)
                        continue
                    va = [float(t) for t in str(a).split(delimiter)]
                    vb = [float(t) for t in str(b).split(delimiter)]
                    if len(va) != len(vb):
                        raise ValueError(
                            f"coordinatesDistanceTransform: {a!r} has "
                            f"{len(va)} dims, {b!r} has {len(vb)}")
                    r.append(sum((x - y) ** 2
                                 for x, y in zip(va, vb)) ** 0.5)
                return Schema(schema._cols
                              + [(newColumnName, "double", None)]), recs
            self._steps.append(step)
            return self

        def build(self):
            # the SAME list objects, not copies: _steps is already
            # shared, so _spec/_unserializable must stay in lockstep —
            # a builder mutated after build() must not leave the built
            # process executing steps its serialized form omits
            return TransformProcess(self._initial, self._steps,
                                    spec=self._spec,
                                    unserializable=self._unserializable)

    def __init__(self, initial, steps, spec=None, unserializable=None):
        self._initial = initial
        self._steps = steps
        self._spec = spec
        self._unserializable = [] if unserializable is None \
            else unserializable

    def getInitialSchema(self) -> Schema:
        return self._initial

    def getFinalSchema(self) -> Schema:
        schema = self._initial
        for s in self._steps:
            schema, _ = s(schema, [])
        return schema

    def execute(self, records) -> list:
        schema = self._initial
        recs = [list(r) for r in records]
        for s in self._steps:
            schema, recs = s(schema, recs)
        return recs

    # ------------- JSON serde (reference: TransformProcess.toJson /
    # fromJson — DataVec pipelines persist next to the model) ---------
    def toJson(self) -> str:
        import json as _json

        if self._unserializable:
            raise ValueError(
                "pipeline contains steps whose arguments cannot be "
                f"serialized: {self._unserializable} — raw callables "
                "have no portable form; use "
                "ConditionFilter(ColumnCondition(...)) for "
                "JSON-representable predicates")
        if self._spec is None:
            raise ValueError("this TransformProcess was constructed "
                             "directly from step closures, not through "
                             "Builder — no declarative spec to serialize")
        return _json.dumps({
            "initialSchema": {"columns": self._initial._cols},
            "steps": self._spec,
        }, indent=1)

    @staticmethod
    def fromJson(text: str) -> "TransformProcess":
        import json as _json

        from deeplearning4j_tpu_torch.util import serde as _serde

        d = _json.loads(text)
        cols = [(n, k, m) for n, k, m in d["initialSchema"]["columns"]]
        b = TransformProcess.Builder(Schema(cols))
        for entry in d["steps"]:
            args = _serde.decode(entry["args"], [])
            kwargs = _serde.decode(entry["kwargs"], [])
            getattr(b, entry["op"])(*args, **kwargs)
        return b.build()


def _install_spec_recording():
    """Wrap every chainable TransformProcess.Builder method to log its
    call declaratively for toJson/fromJson, using the package's shared
    tagged-tree codec (util/serde.py) — which snapshots mutable args at
    record time, preserves non-string dict keys, handles numpy scalars
    and in-package objects (ColumnCondition/ConditionFilter), and
    refuses functions. A step whose arguments the codec rejects (a raw
    callable predicate) marks the pipeline unserializable — recorded,
    surfaced by toJson's error."""
    import functools

    from deeplearning4j_tpu_torch.util import serde as _serde

    B = TransformProcess.Builder

    def wrap(name, fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            out = fn(self, *args, **kwargs)
            try:
                arrays = []
                e_args = _serde.encode(list(args), arrays)
                e_kwargs = _serde.encode(kwargs, arrays)
                if arrays:  # transform args are config scalars, never
                    raise TypeError("array-valued transform argument")
                self._spec.append({"op": name, "args": e_args,
                                   "kwargs": e_kwargs})
            except TypeError:
                self._unserializable.append(name)
            return out
        return wrapper

    for name, fn in list(vars(B).items()):
        if name.startswith("_") or name == "build":
            continue
        setattr(B, name, wrap(name, fn))


_install_spec_recording()


# ----------------------------------------------- reader -> DataSet iterator
class RecordReaderDataSetIterator:
    """Reference: org.deeplearning4j.datasets.datavec.RecordReaderDataSetIterator.
    Materialises the reader once, then behaves as a standard fixed-shape
    batch iterator (classification one-hot or regression labels)."""

    def __init__(self, recordReader: RecordReader, batchSize: int,
                 labelIndex: int = -1, numPossibleLabels: int = None,
                 regression: bool = False, shuffle=False, seed=123):
        feats, labels = [], []
        recordReader.reset()
        # readers whose records are [ndarray, labelIndex] (images, audio)
        # rather than flat value lists mark themselves arrayRecords
        image_mode = getattr(recordReader, "arrayRecords", False)
        # bulk fast path: EXACTLY CSVRecordReader (not subclasses — an
        # overridden next()/_parse must keep its say) can hand over the
        # whole file as one numeric matrix; None falls through
        m = (recordReader.asMatrix()
             if type(recordReader) is CSVRecordReader else None)
        if m is not None and m.ndim == 2 and m.shape[1] >= 1:
            li = labelIndex if labelIndex >= 0 else m.shape[1] - 1
            f = np.delete(m, li, axis=1)
            labels = m[:, li].tolist()
            recordReader._i = len(recordReader._lines)  # consumed, like
            # the record loop leaves it
        else:
            while recordReader.hasNext():
                rec = recordReader.next()
                if image_mode:
                    feats.append(rec[0])
                    labels.append(rec[1])
                else:
                    li = labelIndex if labelIndex >= 0 else len(rec) - 1
                    labels.append(rec[li])
                    feats.append([float(v) for j, v in enumerate(rec)
                                  if j != li])
            try:
                f = np.asarray(feats, np.float32)
            except ValueError as e:
                shapes = sorted({np.shape(x) for x in feats})
                raise ValueError(
                    f"records have inconsistent shapes {shapes[:4]}; "
                    "batching needs fixed-size records "
                    "(WavFileRecordReader: pass length=N to pad/truncate)"
                ) from e
        if regression:
            l = np.asarray(labels, np.float32).reshape(len(labels), -1)
        else:
            n_cls = numPossibleLabels or (recordReader.numLabels() if image_mode
                                          else int(max(labels)) + 1)
            l = np.eye(n_cls, dtype=np.float32)[np.asarray(labels, np.int64)]
        from deeplearning4j_tpu_torch.data.dataset import DataSetIterator

        self._it = DataSetIterator(f, l, batchSize, shuffle=shuffle, seed=seed)

    def __getattr__(self, name):  # delegate iterator protocol
        return getattr(self._it, name)

    def __iter__(self):
        return iter(self._it)


class CSVSequenceRecordReader(RecordReader):
    """Time-series reader: each FILE is one sequence, each line one time
    step (reference: datavec CSVSequenceRecordReader). initialize() takes
    a directory (files sorted by name) or an explicit list of paths;
    next() returns the sequence as a list of per-step value lists."""

    def __init__(self, skipNumLines: int = 0, delimiter: str = ","):
        self.skip = int(skipNumLines)
        self.delim = delimiter
        self._files = []
        self._i = 0

    def initialize(self, source):
        import os

        if isinstance(source, (list, tuple)):
            self._files = [str(p) for p in source]
        elif os.path.isdir(source):
            self._files = sorted(
                p for p in (os.path.join(source, f)
                            for f in os.listdir(source)
                            if not f.startswith("."))
                if os.path.isfile(p))
        else:
            self._files = [str(source)]
        self._i = 0
        return self

    def hasNext(self):
        return self._i < len(self._files)

    def next(self):
        path = self._files[self._i]
        self._i += 1
        seq = []
        with open(path) as fh:
            for li, line in enumerate(fh):
                if li < self.skip:
                    continue
                line = line.strip()
                if not line:
                    continue
                seq.append([CSVRecordReader._parse(t)
                            for t in line.split(self.delim)])
        if not seq:
            raise ValueError(f"empty sequence file: {path}")
        return seq

    def reset(self):
        self._i = 0


class SequenceRecordReaderDataSetIterator:
    """Zip a features sequence reader with a labels sequence reader into
    padded+masked recurrent DataSets (reference:
    SequenceRecordReaderDataSetIterator, ALIGN_END-free equal-length or
    padded variable-length batches).

    Output layout matches the recurrent layers' NCW convention:
    features [B, F, T], labels [B, C, T] (one-hot classification when
    numPossibleLabels is set, raw values for regression=True), masks
    [B, T] marking real steps. Sequences in a batch are padded to the
    batch's longest sequence — static shapes per batch, mask-correct
    losses (the fixed-shape form of the reference's variable-length
    handling)."""

    def __init__(self, featureReader, labelReader, miniBatchSize,
                 numPossibleLabels=-1, regression=False):
        if (numPossibleLabels is None or numPossibleLabels < 1) \
                and not regression:
            raise ValueError(
                "classification needs numPossibleLabels >= 1 "
                "(or pass regression=True)")
        self._fr = featureReader
        self._lr = labelReader
        self.batch = int(miniBatchSize)
        self.numLabels = -1 if numPossibleLabels is None \
            else int(numPossibleLabels)
        self.regression = bool(regression)

    def reset(self):
        self._fr.reset()
        self._lr.reset()

    def hasNext(self):
        return self._fr.hasNext() and self._lr.hasNext()

    def next(self, num=None):
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        n = self.batch if num is None else int(num)
        if n <= 0:
            raise ValueError(f"batch size must be positive, got {n}")
        fseqs, lseqs = [], []
        while len(fseqs) < n and self.hasNext():
            f = self._fr.next()
            l = self._lr.next()
            if len(f) != len(l):
                raise ValueError(
                    f"feature sequence length {len(f)} != label sequence "
                    f"length {len(l)} (readers must be aligned)")
            fseqs.append(np.asarray(f, dtype="float32"))
            lseqs.append(np.asarray(l, dtype="float32"))
        if not fseqs:
            raise ValueError("iterator exhausted (or empty readers); "
                             "call reset() or check the source paths")
        if self._fr.hasNext() != self._lr.hasNext():
            raise ValueError(
                "feature and label readers hold different sequence counts "
                "— a file pair is missing on one side")
        B = len(fseqs)
        T = max(s.shape[0] for s in fseqs)
        F = fseqs[0].shape[1]
        if self.regression:
            # pin the label width on first use and validate every sequence
            # against it — otherwise a ragged sequence surfaces later as an
            # opaque numpy broadcast error (and the width could silently
            # differ between batches)
            if getattr(self, "_label_width", None) is None:
                self._label_width = lseqs[0].shape[1]
            for i, l in enumerate(lseqs):
                if l.shape[1] != self._label_width:
                    raise ValueError(
                        f"regression label width {l.shape[1]} for sequence "
                        f"{i} of this batch does not match the iterator's "
                        f"established width {self._label_width}; all label "
                        "sequences must have the same number of columns")
            C = self._label_width
        else:
            C = self.numLabels
        x = np.zeros((B, F, T), "float32")
        y = np.zeros((B, C, T), "float32")
        mask = np.zeros((B, T), "float32")
        for i, (f, l) in enumerate(zip(fseqs, lseqs)):
            t = f.shape[0]
            x[i, :, :t] = f.T
            mask[i, :t] = 1.0
            if self.regression:
                y[i, :, :t] = l.T
            else:
                ids = l.astype(int).reshape(t, -1)[:, 0]
                if ids.min() < 0 or ids.max() >= C:
                    bad = ids[(ids < 0) | (ids >= C)][0]
                    raise ValueError(
                        f"label value {bad} outside [0, {C}) "
                        f"(numPossibleLabels={C})")
                y[i, ids, np.arange(t)] = 1.0
        return DataSet(x, y, featuresMask=mask, labelsMask=mask)

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()
