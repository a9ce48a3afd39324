"""DataVec transform DSL: joins, reducers, condition filters, analysis.

The counterpart of ``deeplearning4j_tpu/data/transform.py``, a copy of
its host code; results are exact. Reference: datavec-api org.datavec.api.transform —
  join.Join (Inner/LeftOuter/RightOuter/FullOuter on key columns),
  reduce.Reducer (ReduceOp Sum/Mean/Count/Min/Max/Stdev by key),
  condition.* + filter.ConditionFilter,
  analysis.AnalyzeLocal -> DataAnalysis.
Upstream executes these on Spark; ETL is host-side by design there and
here — the device path starts where RecordReaderDataSetIterator hands
batches to the networks. These operate on the same
(Schema, list-of-records) pairs as data.records.TransformProcess.
"""

from __future__ import annotations

import math
from collections import OrderedDict

from deeplearning4j_tpu_torch.data.records import Schema


# ---------------------------------------------------------------- conditions
class ConditionOp:
    LessThan = "LessThan"
    LessOrEqual = "LessOrEqual"
    GreaterThan = "GreaterThan"
    GreaterOrEqual = "GreaterOrEqual"
    Equal = "Equal"
    NotEqual = "NotEqual"
    InSet = "InSet"
    NotInSet = "NotInSet"

    _FNS = {
        "LessThan": lambda v, t: v < t,
        "LessOrEqual": lambda v, t: v <= t,
        "GreaterThan": lambda v, t: v > t,
        "GreaterOrEqual": lambda v, t: v >= t,
        "Equal": lambda v, t: v == t,
        "NotEqual": lambda v, t: v != t,
        "InSet": lambda v, t: v in t,
        "NotInSet": lambda v, t: v not in t,
    }


class ColumnCondition:
    """Reference: condition.column.*ColumnCondition. Evaluates one column
    of a record dict against a fixed value/set."""

    def __init__(self, column, op, value):
        if op not in ConditionOp._FNS:
            raise ValueError(f"unknown ConditionOp {op!r}")
        self.column = column
        self.op = op
        self.value = set(value) if op in (ConditionOp.InSet,
                                          ConditionOp.NotInSet) else value

    def condition(self, record: dict) -> bool:
        if self.column not in record:
            raise KeyError(f"condition column '{self.column}' not in record "
                           f"(have {sorted(record)})")
        return ConditionOp._FNS[self.op](record[self.column], self.value)


# upstream has typed variants; semantics are identical here
DoubleColumnCondition = ColumnCondition
IntegerColumnCondition = ColumnCondition
CategoricalColumnCondition = ColumnCondition
StringColumnCondition = ColumnCondition


class ConditionFilter:
    """Reference: filter.ConditionFilter — REMOVES records matching the
    condition. Usable directly as TransformProcess.Builder.filter(...)'s
    predicate."""

    def __init__(self, condition):
        self._c = condition

    def __call__(self, record: dict) -> bool:
        return self._c.condition(record)

    removeExample = __call__


# ---------------------------------------------------------------------- join
class Join:
    """Reference: transform.join.Join."""

    Inner = "Inner"
    LeftOuter = "LeftOuter"
    RightOuter = "RightOuter"
    FullOuter = "FullOuter"

    class Builder:
        def __init__(self, joinType="Inner"):
            if joinType not in (Join.Inner, Join.LeftOuter, Join.RightOuter,
                                Join.FullOuter):
                raise ValueError(f"unknown join type {joinType!r}")
            self._type = joinType
            self._keys = None
            self._left = None
            self._right = None

        def setJoinColumns(self, *names):
            self._keys = list(names)
            return self

        def setSchemas(self, left: Schema, right: Schema):
            self._left, self._right = left, right
            return self

        def build(self):
            if not self._keys or self._left is None or self._right is None:
                raise ValueError("Join needs setJoinColumns and setSchemas")
            for k in self._keys:
                for side, sch in (("left", self._left), ("right", self._right)):
                    if k not in sch.getColumnNames():
                        raise ValueError(
                            f"join column '{k}' missing from {side} schema "
                            f"{sch.getColumnNames()}")
            return Join(self._type, self._keys, self._left, self._right)

    def __init__(self, joinType, keys, left, right):
        self.joinType = joinType
        self.keys = keys
        self.left = left
        self.right = right

    def getOutputSchema(self) -> Schema:
        """Key columns once, then left non-key columns, then right
        non-key columns (upstream's column order)."""
        cols = [self.left._cols[self.left.getIndexOfColumn(k)]
                for k in self.keys]
        for n, k, m in self.left._cols:
            if n not in self.keys:
                cols.append((n, k, m))
        for n, k, m in self.right._cols:
            if n not in self.keys:
                cols.append((n, k, m))
        names = [c[0] for c in cols]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(
                f"joined schemas share non-key column names {sorted(dupes)}; "
                "rename them first (TransformProcess renameColumn)")
        return Schema(cols)


def executeJoin(join: Join, leftRecords, rightRecords):
    """Local join execution (reference: upstream executes Join on Spark;
    the algorithm — hash-join on the key tuple — is the same).
    Returns (outputSchema, records). Missing side in outer joins fills
    None (upstream NullWritable)."""
    out_schema = join.getOutputSchema()
    lnames = join.left.getColumnNames()
    rnames = join.right.getColumnNames()
    lkey = [join.left.getIndexOfColumn(k) for k in join.keys]
    rkey = [join.right.getIndexOfColumn(k) for k in join.keys]
    lrest = [i for i, n in enumerate(lnames) if n not in join.keys]
    rrest = [i for i, n in enumerate(rnames) if n not in join.keys]

    rindex = OrderedDict()
    for r in rightRecords:
        rindex.setdefault(tuple(r[i] for i in rkey), []).append(r)

    out = []
    matched_rkeys = set()
    for l in leftRecords:
        key = tuple(l[i] for i in lkey)
        matches = rindex.get(key)
        if matches:
            matched_rkeys.add(key)
            for r in matches:
                out.append(list(key) + [l[i] for i in lrest]
                           + [r[i] for i in rrest])
        elif join.joinType in (Join.LeftOuter, Join.FullOuter):
            out.append(list(key) + [l[i] for i in lrest]
                       + [None] * len(rrest))
    if join.joinType in (Join.RightOuter, Join.FullOuter):
        for key, rows in rindex.items():
            if key not in matched_rkeys:
                for r in rows:
                    out.append(list(key) + [None] * len(lrest)
                               + [r[i] for i in rrest])
    return out_schema, out


# ------------------------------------------------------------------- reducer
class ReduceOp:
    Sum = "Sum"
    Mean = "Mean"
    Count = "Count"
    Min = "Min"
    Max = "Max"
    Stdev = "Stdev"
    TakeFirst = "TakeFirst"
    TakeLast = "TakeLast"


def _stdev(vals):
    n = len(vals)
    if n < 2:
        return 0.0
    m = sum(vals) / n
    return math.sqrt(sum((v - m) ** 2 for v in vals) / (n - 1))  # sample,
    # matching upstream's StandardDeviation


_REDUCE_FNS = {
    ReduceOp.Sum: lambda vs: sum(float(v) for v in vs),
    ReduceOp.Mean: lambda vs: sum(float(v) for v in vs) / len(vs),
    ReduceOp.Count: len,
    ReduceOp.Min: lambda vs: min(float(v) for v in vs),
    ReduceOp.Max: lambda vs: max(float(v) for v in vs),
    ReduceOp.Stdev: lambda vs: _stdev([float(v) for v in vs]),
    ReduceOp.TakeFirst: lambda vs: vs[0],
    ReduceOp.TakeLast: lambda vs: vs[-1],
}


class Reducer:
    """Reference: transform.reduce.Reducer — group records by key
    columns, aggregate every other column."""

    class Builder:
        def __init__(self, defaultOp=ReduceOp.TakeFirst):
            if defaultOp not in _REDUCE_FNS:
                raise ValueError(f"unknown ReduceOp {defaultOp!r}")
            self._default = defaultOp
            self._keys = []
            self._ops = {}  # column -> op

        def keyColumns(self, *names):
            self._keys = list(names)
            return self

        def _add(self, op, names):
            for n in names:
                self._ops[n] = op
            return self

        def sumColumns(self, *names):
            return self._add(ReduceOp.Sum, names)

        def meanColumns(self, *names):
            return self._add(ReduceOp.Mean, names)

        def countColumns(self, *names):
            return self._add(ReduceOp.Count, names)

        def minColumns(self, *names):
            return self._add(ReduceOp.Min, names)

        def maxColumns(self, *names):
            return self._add(ReduceOp.Max, names)

        def stdevColumns(self, *names):
            return self._add(ReduceOp.Stdev, names)

        def takeFirstColumns(self, *names):
            return self._add(ReduceOp.TakeFirst, names)

        def takeLastColumns(self, *names):
            return self._add(ReduceOp.TakeLast, names)

        def build(self):
            if not self._keys:
                raise ValueError("Reducer needs keyColumns(...)")
            return Reducer(self._keys, self._ops, self._default)

    def __init__(self, keys, ops, default):
        self.keys = keys
        self.ops = ops
        self.default = default

    def _op_for(self, name):
        return self.ops.get(name, self.default)

    def getOutputSchema(self, schema: Schema) -> Schema:
        cols = []
        for n, k, m in schema._cols:
            if n in self.keys:
                cols.append((n, k, m))
                continue
            op = self._op_for(n)
            if op == ReduceOp.Count:
                cols.append((f"count({n})", "integer", None))
            elif op in (ReduceOp.TakeFirst, ReduceOp.TakeLast):
                cols.append((n, k, m))
            else:
                cols.append((f"{op.lower()}({n})", "double", None))
        return Schema(cols)

    def execute(self, schema: Schema, records):
        """-> (outputSchema, one record per distinct key, in first-seen
        key order)."""
        names = schema.getColumnNames()
        for k in self.keys:
            if k not in names:
                raise ValueError(f"key column '{k}' not in schema {names}")
        kidx = [schema.getIndexOfColumn(k) for k in self.keys]
        groups = OrderedDict()
        for r in records:
            groups.setdefault(tuple(r[i] for i in kidx), []).append(r)
        out = []
        for key, rows in groups.items():
            rec = []
            for i, n in enumerate(names):
                if n in self.keys:
                    rec.append(key[self.keys.index(n)])
                else:
                    rec.append(_REDUCE_FNS[self._op_for(n)](
                        [r[i] for r in rows]))
            out.append(rec)
        return self.getOutputSchema(schema), out


# ------------------------------------------------------------------ analysis
class NumericalColumnAnalysis:
    def __init__(self, vals):
        self.countTotal = len(vals)
        self.countMissing = sum(1 for v in vals if v is None)
        nums = [float(v) for v in vals if v is not None]
        self.min = min(nums) if nums else float("nan")
        self.max = max(nums) if nums else float("nan")
        self.mean = sum(nums) / len(nums) if nums else float("nan")
        self.sampleStdev = _stdev(nums)
        self.countZero = sum(1 for v in nums if v == 0.0)
        self.countNegative = sum(1 for v in nums if v < 0.0)

    def __repr__(self):
        return (f"min={self.min:g} max={self.max:g} mean={self.mean:g} "
                f"stdev={self.sampleStdev:g} n={self.countTotal} "
                f"missing={self.countMissing}")


class CategoricalColumnAnalysis:
    def __init__(self, vals):
        self.countTotal = len(vals)
        self.countMissing = sum(1 for v in vals if v is None)
        counts = {}
        for v in vals:
            if v is not None:
                counts[v] = counts.get(v, 0) + 1
        self.mapOfUniqueAndCounts = counts

    def getUnique(self):
        return sorted(self.mapOfUniqueAndCounts)

    def __repr__(self):
        return (f"states={self.getUnique()} n={self.countTotal} "
                f"missing={self.countMissing}")


class DataAnalysis:
    """Reference: transform.analysis.DataAnalysis (AnalyzeLocal output):
    per-column summary statistics, printable as a table."""

    def __init__(self, schema: Schema, analyses: dict):
        self.schema = schema
        self._a = analyses

    def getColumnAnalysis(self, name):
        if name not in self._a:
            raise ValueError(f"no analysis for column '{name}' "
                             f"(have {sorted(self._a)})")
        return self._a[name]

    def __repr__(self):
        rows = [f"  {n!r} ({self.schema.getType(n)}): {self._a[n]!r}"
                for n in self.schema.getColumnNames()]
        return "DataAnalysis[\n" + "\n".join(rows) + "\n]"


def analyze(schema: Schema, records) -> DataAnalysis:
    """Reference: AnalyzeLocal.analyze(schema, recordReader) — here over
    materialised records (the reader is already list-like host-side)."""
    analyses = {}
    for i, name in enumerate(schema.getColumnNames()):
        vals = [r[i] for r in records]
        if schema.getType(name) in ("double", "integer"):
            analyses[name] = NumericalColumnAnalysis(vals)
        else:
            analyses[name] = CategoricalColumnAnalysis(vals)
    return DataAnalysis(schema, analyses)


# --------------------------------------------------------------------
# data quality (reference: datavec-api transform.analysis.quality —
# AnalyzeLocal.analyzeQuality -> DataQualityAnalysis of per-column
# ColumnQuality counts)
# --------------------------------------------------------------------

class ColumnQuality:
    def __init__(self):
        self.countValid = 0
        self.countInvalid = 0
        self.countMissing = 0
        self.countTotal = 0

    def __repr__(self):
        extra = "".join(f" {k}={v}" for k, v in vars(self).items()
                        if k.startswith("count")
                        and k not in ("countValid", "countInvalid",
                                      "countMissing", "countTotal") and v)
        return (f"{type(self).__name__}(valid={self.countValid} "
                f"invalid={self.countInvalid} missing={self.countMissing} "
                f"total={self.countTotal}{extra})")


class DoubleColumnQuality(ColumnQuality):
    def __init__(self):
        super().__init__()
        self.countNaN = 0
        self.countInfinite = 0


class IntegerColumnQuality(ColumnQuality):
    pass


class CategoricalColumnQuality(ColumnQuality):
    pass


class StringColumnQuality(ColumnQuality):
    def __init__(self):
        super().__init__()
        self.countEmptyString = 0


class DataQualityAnalysis:
    """Reference: transform.analysis.quality.DataQualityAnalysis —
    per-column validity audit, printable as a table."""

    def __init__(self, schema: Schema, qualities: dict):
        self.schema = schema
        self._q = qualities

    def getColumnQuality(self, name) -> ColumnQuality:
        if name not in self._q:
            raise ValueError(f"no quality record for column '{name}' "
                             f"(have {sorted(self._q)})")
        return self._q[name]

    def isClean(self) -> bool:
        return all(q.countInvalid == 0 and q.countMissing == 0
                   for q in self._q.values())

    def __repr__(self):
        rows = [f"  {n!r} ({self.schema.getType(n)}): {self._q[n]!r}"
                for n in self.schema.getColumnNames()]
        return "DataQualityAnalysis[\n" + "\n".join(rows) + "\n]"


def _quality_double(vals):
    q = DoubleColumnQuality()
    for v in vals:
        if v is None:
            q.countMissing += 1
            continue
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            f = float(v)
        else:
            try:  # CSV-sourced records are strings: parse THEN classify,
                f = float(str(v))  # so 'nan'/'1e999' can't count valid
            except ValueError:
                q.countInvalid += 1
                continue
        if math.isnan(f):
            q.countNaN += 1
            q.countInvalid += 1
        elif math.isinf(f):
            q.countInfinite += 1
            q.countInvalid += 1
        else:
            q.countValid += 1
    return q


def _quality_integer(vals):
    q = IntegerColumnQuality()
    for v in vals:
        if v is None:
            q.countMissing += 1
        elif isinstance(v, bool):
            q.countInvalid += 1
        elif isinstance(v, int):
            q.countValid += 1
        elif isinstance(v, float):
            # non-finite floats cannot be int(v)'d — they are invalid,
            # not a crash (a quality audit must tolerate dirty data)
            if math.isfinite(v) and v == int(v):
                q.countValid += 1  # integral float parses upstream
            else:
                q.countInvalid += 1
        else:
            try:
                int(str(v))
                q.countValid += 1
            except ValueError:
                q.countInvalid += 1
    return q


def _quality_categorical(vals, states):
    q = CategoricalColumnQuality()
    for v in vals:
        if v is None:
            q.countMissing += 1
        elif states is not None and v in states:
            q.countValid += 1
        else:
            q.countInvalid += 1
    return q


def _quality_string(vals):
    q = StringColumnQuality()
    for v in vals:
        if v is None:
            q.countMissing += 1
        elif isinstance(v, str):
            q.countValid += 1
            if v == "":
                q.countEmptyString += 1
        else:
            q.countInvalid += 1
    return q


def analyzeQuality(schema: Schema, records) -> DataQualityAnalysis:
    """Reference: AnalyzeLocal.analyzeQuality(schema, recordReader).
    Every count* field sums to countTotal per column; `isClean()` is the
    gate a pipeline checks before training."""
    qualities = {}
    for i, name in enumerate(schema.getColumnNames()):
        vals = [r[i] for r in records]
        typ = schema.getType(name)
        if typ == "double":
            q = _quality_double(vals)
        elif typ == "integer":
            q = _quality_integer(vals)
        elif typ == "categorical":
            q = _quality_categorical(vals, schema.getMeta(name))
        else:
            q = _quality_string(vals)
        q.countTotal = len(vals)
        qualities[name] = q
    return DataQualityAnalysis(schema, qualities)
