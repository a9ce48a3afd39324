"""The port's DataVec readers, native CSV parser, TransformProcess (and
its JSON) and columnar files against the reference's: the same seeded
inputs through both packages, compared exactly (parsed floats, records,
batches, schemas, JSON, files byte for byte). Mirrors
``tests/test_textparse.py``, ``tests/test_columnar.py`` and the
record-reader and TransformProcess classes of ``tests/test_data.py``."""

import json

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.data as J
import deeplearning4j_tpu_torch.data as P
from deeplearning4j_tpu.runtime import textparse as jtp
from deeplearning4j_tpu_torch.runtime import textparse as ptp

torch.set_num_threads(1)


def norm(x):
    """A result as plain comparable data: arrays (INDArray, tensor,
    numpy) as (dtype, shape, bytes), NaN as a tag."""
    if hasattr(x, "toNumpy"):
        x = x.toNumpy()
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if isinstance(x, np.ndarray):
        return ("nd", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, float) and x != x:
        return "nan"
    return x


def _batches(it):
    out = []
    while it.hasNext():
        ds = it.next()
        out.append([ds.getFeatures(), ds.getLabels(),
                    ds.getFeaturesMaskArray(), ds.getLabelsMaskArray()])
    return out


# ---------------------------------------------------------- native parser
_PARSE_CASES = {
    "rectangle": (b"1,2,3\n4.5,-6e2,7\n", ",", 0),
    "messy_whitespace_crlf": (b" 1 , 2 \r\n\r\n3,4\t\r\n", ",", 0),
    "header": (b"a,b\n1,2\n3,4\n", ",", 1),
    "semicolon": (b"1;2\n3;4\n", ";", 0),
    "ragged": (b"1,2\n3\n", ",", 0),
    "non_numeric": (b"1,x\n", ",", 0),
    "empty_field": (b"1,,2\n", ",", 0),
    "hex_float": (b"0x1A,2\n", ",", 0),
    "inf_nan": (b"inf,nan\n", ",", 0),
    "whitespace_delim": (b"1 2\n", " ", 0),
    "short_header": (b"h\n1,2,3,4\n5,6,7,8\n", ",", 1),
    "random_matrix": (
        "\n".join(",".join(f"{v:.7g}" for v in row) for row in
                  np.random.RandomState(0).randn(200, 17)).encode(), ",", 0),
}


@pytest.mark.parametrize("case", sorted(_PARSE_CASES))
def test_native_parser_matches_the_reference(case):
    data, delim, skip = _PARSE_CASES[case]
    got = ptp.parse_csv_f32(data, delim, skip)
    want = jtp.parse_csv_f32(data, delim, skip)
    assert norm(got) == norm(want)


# -------------------------------------------------------- record readers
def _csv_file(tmp_path, rows, name="d.csv"):
    p = tmp_path / name
    p.write_text("\n".join(rows))
    return p


def sc_csv_records(D, tmp_path):
    p = _csv_file(tmp_path, ["# header", "1.5,2,hello", "3.5,4,world"])
    rr = D.CSVRecordReader(skipNumLines=1).initialize(p)
    return list(rr)


def sc_csv_classification(D, tmp_path):
    p = _csv_file(tmp_path, ["%f,%f,%d" % (i * 0.1, i * 0.2, i % 3)
                             for i in range(30)])
    it = D.RecordReaderDataSetIterator(D.CSVRecordReader().initialize(p),
                                       batchSize=8, labelIndex=2,
                                       numPossibleLabels=3)
    return _batches(it)


def sc_csv_mixed_falls_back(D, tmp_path):
    """A non-numeric cell: the parser hands the file to the record loop."""
    p = _csv_file(tmp_path, ["1,2,0", "3,x,1", "5,6,0"])
    rr = D.CSVRecordReader().initialize(p)
    return [rr.asMatrix() is None, list(rr)]


def sc_csv_regression_fast_path(D, tmp_path):
    rng = np.random.RandomState(3)
    p = _csv_file(tmp_path, [",".join(f"{v:.5f}" for v in r)
                             for r in rng.randn(25, 4)])
    it = D.RecordReaderDataSetIterator(D.CSVRecordReader().initialize(p),
                                       batchSize=10, labelIndex=1,
                                       regression=True, shuffle=True,
                                       seed=7)
    return _batches(it)


def sc_collection_regression(D, tmp_path):
    rr = D.CollectionRecordReader([[1.0, 2.0, 10.0], [3.0, 4.0, 20.0]])
    return _batches(D.RecordReaderDataSetIterator(rr, batchSize=2,
                                                  labelIndex=2,
                                                  regression=True))


def sc_image_reader(D, tmp_path):
    from PIL import Image

    rng = np.random.RandomState(0)
    for cls in ("cats", "dogs"):
        d = tmp_path / cls
        d.mkdir(exist_ok=True)
        for i in range(3):
            Image.fromarray(rng.randint(0, 255, (12, 10, 3), np.uint8)).save(
                d / f"{i}.png")
    rr = D.ImageRecordReader(height=8, width=8, channels=3).initialize(
        tmp_path)
    return [rr.getLabels(), _batches(D.RecordReaderDataSetIterator(
        rr, batchSize=4))]


def _write_seqs(tmp_path, lengths, nfeat=3):
    fdir, ldir = tmp_path / "features", tmp_path / "labels"
    fdir.mkdir(exist_ok=True)
    ldir.mkdir(exist_ok=True)
    rng = np.random.RandomState(0)
    for i, T in enumerate(lengths):
        feats = rng.rand(T, nfeat)
        labs = rng.randint(0, 2, (T, 1))
        (fdir / f"seq_{i}.csv").write_text(
            "\n".join(",".join(f"{v:.6f}" for v in row) for row in feats))
        (ldir / f"seq_{i}.csv").write_text(
            "\n".join(str(int(v[0])) for v in labs))
    return str(fdir), str(ldir)


def sc_sequence_reader_pads_and_masks(D, tmp_path):
    fdir, ldir = _write_seqs(tmp_path, [4, 6, 5, 3])
    it = D.SequenceRecordReaderDataSetIterator(
        D.CSVSequenceRecordReader().initialize(fdir),
        D.CSVSequenceRecordReader().initialize(ldir),
        miniBatchSize=3, numPossibleLabels=2)
    it.reset()
    return _batches(it)


def sc_sequence_regression(D, tmp_path):
    fdir, ldir = _write_seqs(tmp_path, [4, 6])
    it = D.SequenceRecordReaderDataSetIterator(
        D.CSVSequenceRecordReader().initialize(fdir),
        D.CSVSequenceRecordReader().initialize(ldir),
        miniBatchSize=2, regression=True)
    it.reset()
    return _batches(it)


# ------------------------------------------------------ TransformProcess
def _schema(D):
    return (D.Schema.Builder().addColumnsDouble("a", "b")
            .addColumnCategorical("cat", "x", "y", "z")
            .addColumnString("junk").build())


_RECS = [[1.0, 2.0, "y", "drop"], [3.0, 4.0, "z", "drop"],
         [-1.5, 0.0, "x", ""]]


def _tp_remove_math(D):
    return (D.TransformProcess.Builder(_schema(D)).removeColumns("junk")
            .doubleMathOp("a", "Multiply", 2.0)
            .categoricalToInteger("cat").build())


def _tp_one_hot(D):
    return (D.TransformProcess.Builder(_schema(D)).removeColumns("junk")
            .categoricalToOneHot("cat").build())


def _tp_condition(D):
    return (D.TransformProcess.Builder(_schema(D))
            .filter(D.ConditionFilter(D.DoubleColumnCondition(
                "a", D.ConditionOp.LessThan, 0.0)))
            .conditionalReplaceValueTransform(
                "b", -1.0, D.DoubleColumnCondition(
                    "b", D.ConditionOp.GreaterThan, 3.0))
            .renameColumn("junk", "note").build())


def _tp_breadth(D):
    return (D.TransformProcess.Builder(_schema(D))
            .doubleColumnsMathOp("ratio", "Divide", "a", "b")
            .addConstantColumn("ds", "string", "train")
            .duplicateColumn("a", "a_copy")
            .stringMapTransform("junk", {"drop": "kept"})
            .appendStringColumnTransform("junk", "_v1")
            .reorderColumns("ds", "cat")
            .replaceMissingWithValue("b", -7.0)
            .build())


_TPS = {"remove_math": _tp_remove_math, "one_hot": _tp_one_hot,
        "condition": _tp_condition, "breadth": _tp_breadth}


@pytest.mark.parametrize("name", sorted(_TPS))
def test_transform_process_executes_as_the_reference(name):
    jt, pt = _TPS[name](J), _TPS[name](P)
    assert norm(pt.execute(_RECS)) == norm(jt.execute(_RECS))
    assert pt.getFinalSchema()._cols == jt.getFinalSchema()._cols
    assert pt.toJson() == jt.toJson()


@pytest.mark.parametrize("name", sorted(_TPS))
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_transform_process_json_crosses_both_ways(name, direction):
    src, dst = (J, P) if direction == "ref_to_port" else (P, J)
    text = _TPS[name](src).toJson()
    back = dst.TransformProcess.fromJson(text)
    assert back.toJson() == text
    assert norm(back.execute(_RECS)) == norm(_TPS[name](src).execute(_RECS))


def test_raw_callable_filter_refuses_json():
    tp = (P.TransformProcess.Builder(_schema(P))
          .filter(lambda rec: rec["a"] > 0).build())
    assert len(tp.execute(_RECS)) == 1
    with pytest.raises(ValueError, match="cannot be serialized"):
        tp.toJson()
    json.loads(_tp_condition(P).toJson())


# ---------------------------------------------------------------- columnar
def _col_schema(D):
    return (D.Schema.Builder().addColumnDouble("x").addColumnInteger("n")
            .addColumnCategorical("cat", "a", "b", "c")
            .addColumnString("s").build())


_COL_RECS = [[1.5, 7, "a", "hello"], [-2.25, 0, "b", ""],
             [None, 3, "c", "wörld"], [3.75, None, "a", None],
             [float(2 ** 40), 2 ** 53 + 1, "b", "x" * 300]]


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_columnar_files_cross_byte_for_byte(tmp_path, direction):
    src, dst = (J, P) if direction == "ref_to_port" else (P, J)
    a, b = tmp_path / "a.ndc", tmp_path / "b.ndc"
    src.writeColumnar(a, _col_schema(src), _COL_RECS)
    dst.writeColumnar(b, _col_schema(dst), _COL_RECS)
    assert a.read_bytes() == b.read_bytes()
    assert norm(list(dst.ColumnarRecordReader().initialize(a))) == \
        norm(list(src.ColumnarRecordReader().initialize(a)))
    assert norm(dst.ColumnarRecordReader().initialize(a).asColumns()) == \
        norm(src.ColumnarRecordReader().initialize(a).asColumns())


def test_columnar_guards_as_the_reference(tmp_path):
    schema = P.Schema.Builder().addColumnInteger("n").build()
    with pytest.raises(ValueError, match="non-integral"):
        P.writeColumnar(tmp_path / "x.ndc", schema, [[1.7]])
    (tmp_path / "junk.ndc").write_bytes(b"NOPE" + b"\x00" * 16)
    with pytest.raises(ValueError, match="NDC1"):
        P.ColumnarRecordReader().initialize(tmp_path / "junk.ndc")
    import inspect
    from deeplearning4j_tpu_torch.data import columnar

    assert "4 GiB" in inspect.getsource(columnar) or \
        "2 ** 32" in inspect.getsource(columnar)


def sc_columnar_into_iterator(D, tmp_path):
    rng = np.random.RandomState(1)
    recs = [[float(rng.randn()), float(rng.randn()), int(rng.randint(0, 3))]
            for _ in range(40)]
    schema = (D.Schema.Builder().addColumnsDouble("f0", "f1")
              .addColumnInteger("label").build())
    p = tmp_path / "train.ndc"
    D.writeColumnar(p, schema, recs)
    return _batches(D.RecordReaderDataSetIterator(
        D.ColumnarRecordReader().initialize(p), batchSize=16, labelIndex=2,
        numPossibleLabels=3))


_SCENARIOS = {n[3:]: f for n, f in dict(globals()).items()
              if n.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_scenario_matches_the_reference(name, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = _SCENARIOS[name](J, tmp_path / "j")
    got = _SCENARIOS[name](P, tmp_path / "p")
    assert norm(got) == norm(want)
