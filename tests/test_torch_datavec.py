"""The port's DataVec transform DSL (joins, reducers, condition filters,
analyses, the geo transform) and RecordReaderMultiDataSetIterator
against the reference's, exactly: the same records through both
packages. Mirrors ``tests/test_data.py``'s TestTransformDSL,
TestTransformBreadth, TestRecordReaderMultiDataSetIterator and
TestSequenceMultiReader and ``tests/test_columnar.py``'s quality and
distance classes; a multi-input graph trains from the port's reader."""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.data as J
import deeplearning4j_tpu_torch.data as P

from test_torch_records import norm

torch.set_num_threads(1)


def _join_schemas(D):
    left = (D.Schema.Builder().addColumnString("user")
            .addColumnDouble("amount").build())
    right = (D.Schema.Builder().addColumnString("user")
             .addColumnCategorical("tier", "gold", "basic").build())
    return left, right


_LRECS = [["ann", 10.0], ["bob", 5.0], ["ann", 2.5], ["eve", 1.0]]
_RRECS = [["ann", "gold"], ["bob", "basic"], ["zoe", "basic"]]


@pytest.mark.parametrize("jtype", ["Inner", "LeftOuter", "RightOuter",
                                   "FullOuter"])
def test_join_matches_the_reference(jtype):
    def run(D):
        left, right = _join_schemas(D)
        join = (D.Join.Builder(jtype).setJoinColumns("user")
                .setSchemas(left, right).build())
        schema, out = D.executeJoin(join, _LRECS, _RRECS)
        return [schema._cols, out]

    assert norm(run(P)) == norm(run(J))


def _reduce_recs():
    rng = np.random.RandomState(0)
    return [[str(rng.choice(["a", "b", "c"])), float(rng.randn()),
             float(rng.randn()), str(rng.choice(["p", "q"]))]
            for _ in range(40)]


_REDUCERS = {
    "mean_sum_stdev": lambda D: (D.Reducer.Builder(D.ReduceOp.Mean)
                                 .keyColumns("k").sumColumns("x")
                                 .stdevColumns("y")
                                 .takeLastColumns("tag").build()),
    "takelast_count": lambda D: (D.Reducer.Builder(D.ReduceOp.TakeLast)
                                 .keyColumns("k").countColumns("x")
                                 .build()),
    "min_max_first": lambda D: (D.Reducer.Builder(D.ReduceOp.Min)
                                .keyColumns("k").maxColumns("x")
                                .takeFirstColumns("tag").build()),
}


@pytest.mark.parametrize("name", sorted(_REDUCERS))
def test_reducer_matches_the_reference(name):
    def run(D):
        schema = (D.Schema.Builder().addColumnString("k")
                  .addColumnsDouble("x", "y").addColumnString("tag")
                  .build())
        out_schema, out = _REDUCERS[name](D).execute(schema, _reduce_recs())
        return [out_schema._cols, out]

    assert norm(run(P)) == norm(run(J))


_COND = [[10.0, "gold"], [0.5, "basic"], [3.0, "basic"], [0.1, "gold"],
         [3.0, "gold"]]


@pytest.mark.parametrize("cond", ["double_lt", "cat_inset", "col_gt",
                                  "double_ne"])
def test_condition_filter_matches_the_reference(cond):
    def run(D):
        schema = (D.Schema.Builder().addColumnDouble("amount")
                  .addColumnCategorical("tier", "gold", "basic").build())
        c = {"double_lt": lambda: D.DoubleColumnCondition(
                 "amount", D.ConditionOp.LessThan, 1.0),
             "cat_inset": lambda: D.CategoricalColumnCondition(
                 "tier", D.ConditionOp.InSet, {"basic"}),
             "col_gt": lambda: D.ColumnCondition(
                 "amount", D.ConditionOp.GreaterThan, 2.0),
             "double_ne": lambda: D.DoubleColumnCondition(
                 "amount", D.ConditionOp.NotEqual, 3.0)}[cond]()
        tp = (D.TransformProcess.Builder(schema)
              .filter(D.ConditionFilter(c)).build())
        return [tp.execute(_COND), tp.toJson()]

    assert norm(run(P)) == norm(run(J))


def test_analyze_matches_the_reference():
    def run(D):
        schema = (D.Schema.Builder().addColumnDouble("x")
                  .addColumnInteger("n")
                  .addColumnCategorical("c", "u", "v")
                  .addColumnString("s").build())
        rng = np.random.RandomState(2)
        recs = [[float(rng.randn()), int(rng.randint(-3, 3)),
                 str(rng.choice(["u", "v"])), "w" * int(rng.randint(0, 4))]
                for _ in range(30)] + [[None, None, None, None]]
        da = D.analyze(schema, recs)
        return [repr(da)] + [vars(da.getColumnAnalysis(c))
                             for c in ("x", "n", "c", "s")]

    assert norm(run(P)) == norm(run(J))


def test_analyze_quality_matches_the_reference():
    def run(D):
        schema = (D.Schema.Builder().addColumnDouble("x")
                  .addColumnInteger("n")
                  .addColumnCategorical("cat", "a", "b", "c")
                  .addColumnString("s").build())
        recs = [[1.0, 1, "a", "ok"], [float("nan"), 2.0, "b", ""],
                [float("inf"), "x", "zzz", 7], [None, None, None, None],
                ["nan", float("inf"), "c", "s"], ["1e999", 3, "a", "t"]]
        dqa = D.analyzeQuality(schema, recs)
        return [repr(dqa), dqa.isClean()] + [
            vars(dqa.getColumnQuality(c)) for c in ("x", "n", "cat", "s")]

    assert norm(run(P)) == norm(run(J))


@pytest.mark.parametrize("delimiter", [",", ":"])
def test_coordinates_distance_matches_the_reference(delimiter):
    def run(D):
        schema = (D.Schema.Builder().addColumnString("p1")
                  .addColumnString("p2").build())
        tp = (D.TransformProcess.Builder(schema)
              .coordinatesDistanceTransform("dist", "p1", "p2",
                                            delimiter=delimiter)
              .build())
        d = delimiter
        recs = [[f"0{d}0", f"3{d}4"], [f"1{d}1{d}1", f"1{d}1{d}1"],
                [None, f"5{d}5"], [f"0.5{d}-2", f"7{d}1e3"]]
        return [tp.execute(recs), tp.toJson(),
                D.TransformProcess.fromJson(tp.toJson()).execute(recs)]

    assert norm(run(P)) == norm(run(J))


def _csv(D, tmp_path, name, rows):
    p = tmp_path / name
    p.write_text("\n".join(",".join(str(v) for v in r) for r in rows))
    return D.CSVRecordReader().initialize(p)


def _mds_all(it):
    out = []
    while it.hasNext():
        m = it.next()
        out.append([m.getFeatures(), m.getLabels(),
                    m.getFeaturesMaskArrays(), m.getLabelsMaskArrays()])
    return out


def _seq_reader(D, tmp_path, name, seqs):
    d = tmp_path / name
    d.mkdir()
    for i, rows in enumerate(seqs):
        (d / f"seq_{i:02d}.csv").write_text(
            "\n".join(",".join(str(v) for v in r) for r in rows))
    return D.CSVSequenceRecordReader().initialize(d)


def mr_two_readers(D, tmp_path):
    rr1 = _csv(D, tmp_path, "a.csv", [[i * 0.1, i * 0.2, i * 0.3]
                                      for i in range(10)])
    rr2 = _csv(D, tmp_path, "b.csv", [[i * 1.0, i % 3] for i in range(10)])
    return _mds_all(D.RecordReaderMultiDataSetIterator.Builder(4)
                    .addReader("a", rr1).addReader("b", rr2)
                    .addInput("a", 0, 1).addInput("b", 0, 0)
                    .addOutputOneHot("b", 1, 3).build())


def mr_range_output(D, tmp_path):
    rr = _csv(D, tmp_path, "c.csv", [[i, i + 1, i * 0.5] for i in range(6)])
    return _mds_all(D.RecordReaderMultiDataSetIterator.Builder(6)
                    .addReader("r", rr).addInput("r", 0, 1)
                    .addOutput("r", 2, 2).build())


def mr_sequence_padded_masked(D, tmp_path):
    srr = _seq_reader(D, tmp_path, "s1", [[[1, 10], [2, 20], [3, 30]],
                                          [[4, 40]], [[5, 50], [6, 60]]])
    return _mds_all(D.RecordReaderMultiDataSetIterator.Builder(2)
                    .addSequenceReader("s", srr).addInput("s", 0, 0)
                    .addOutput("s", 1, 1).build())


def mr_sequence_onehot(D, tmp_path):
    srr = _seq_reader(D, tmp_path, "s2", [[[0.5, 0], [0.6, 2]],
                                          [[0.7, 1], [0.8, 1]]])
    return _mds_all(D.RecordReaderMultiDataSetIterator.Builder(2)
                    .addSequenceReader("s", srr).addInput("s", 0, 0)
                    .addOutputOneHot("s", 1, 3).build())


_MR = {n[3:]: f for n, f in dict(globals()).items() if n.startswith("mr_")}


@pytest.mark.parametrize("name", sorted(_MR))
def test_multi_reader_matches_the_reference(name, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    assert norm(_MR[name](P, tmp_path / "p")) == \
        norm(_MR[name](J, tmp_path / "j"))


def test_multi_reader_validation_as_the_reference(tmp_path):
    B = P.RecordReaderMultiDataSetIterator.Builder
    rr = _csv(P, tmp_path, "f.csv", [[1, 2]] * 3)
    with pytest.raises(ValueError, match="unknown reader"):
        B(2).addReader("r", rr).addInput("nope")
    with pytest.raises(ValueError, match="addInput"):
        B(2).addReader("r", rr).addOutput("r", 0, 0).build()
    rr2 = _csv(P, tmp_path, "g.csv", [[1, 9]] * 3)
    with pytest.raises(ValueError, match="outside"):
        (B(2).addReader("r", rr2).addInput("r", 0, 0)
         .addOutputOneHot("r", 1, 3).build())


def test_multi_reader_feeds_a_two_input_graph(tmp_path):
    from deeplearning4j_tpu_torch.nn import (
        Adam, ComputationGraph, DenseLayer, InputType, MergeVertex,
        NeuralNetConfiguration, OutputLayer,
    )

    rng = np.random.RandomState(0)
    a, b = rng.randn(48, 3), rng.randn(48, 2)
    y = ((a.sum(1) + b.sum(1)) > 0).astype(int)
    rr1 = _csv(P, tmp_path, "ga.csv", a.round(4).tolist())
    rr2 = _csv(P, tmp_path, "gb.csv", [[*row.round(4), int(lab)]
                                       for row, lab in zip(b, y)])
    it = (P.RecordReaderMultiDataSetIterator.Builder(16)
          .addReader("a", rr1).addReader("b", rr2)
          .addInput("a").addInput("b", 0, 1).addOutputOneHot("b", 2, 2)
          .build())
    conf = (NeuralNetConfiguration.Builder().seed(3).updater(Adam(1e-2))
            .graphBuilder().addInputs("inA", "inB")
            .addLayer("dA", DenseLayer(nIn=3, nOut=8, activation="tanh"),
                      "inA")
            .addLayer("dB", DenseLayer(nIn=2, nOut=8, activation="tanh"),
                      "inB")
            .addVertex("merge", MergeVertex(), "dA", "dB")
            .addLayer("out", OutputLayer(nOut=2, activation="softmax"),
                      "merge")
            .setOutputs("out")
            .setInputTypes(InputType.feedForward(3), InputType.feedForward(2))
            .build())
    net = ComputationGraph(conf, device="cpu").init()
    for _ in range(40):
        net.fit(it)
    out = net.outputSingle(a.astype("float32"), b.astype("float32"))
    assert (out.toNumpy().argmax(1) == y).mean() > 0.9
