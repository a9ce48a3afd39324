"""The port's public surface against the reference's, package by package
(ROADMAP.md Queue 3, faults 2 and 3).

Every ``__init__.py`` of deeplearning4j_tpu/ is read by AST, as the
import gate reads files: its public names are its ``__all__``, or, where
it has none, the names its top level binds. The port's package at the
same path must offer each of them (in its ``__all__``, its top level or
as a submodule), unless the name is listed below with the ROADMAP.md
Queue 1 item it waits for; every name the port exports must import.
``zoo`` and ``modelimport`` export exactly the reference's ``__all__``.
The deferred features' messages name the item that now holds them, no
message in the port names item 12 but for its part 12b, and none names
12c, which is ported.
"""

import ast
import importlib
import re
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parent.parent
_REF, _PORT = "deeplearning4j_tpu", "deeplearning4j_tpu_torch"

#: names of the reference that wait, by package, with the item that
#: holds them
WAITING = {
    "parallel": ({
        "CHIPS", "ChipSpec", "DataParallelModel", "all_gather_time",
        "all_reduce_time", "compressed_hlo_collective_bytes",
        "ppermute_time",
        "reduce_scatter_time", "resnet50_scaling"}, "7"),
}
#: reference packages with no counterpart yet, with their item
WAITING_PACKAGES = {}


def _public(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


_PACKAGES = sorted(p.parent.relative_to(_ROOT / _REF)
                   for p in (_ROOT / _REF).rglob("__init__.py")
                   if "__pycache__" not in p.parts)


def _dotted(rel):
    return ".".join(rel.parts)


@pytest.mark.parametrize("rel", _PACKAGES, ids=[str(r) or "root"
                                               for r in _PACKAGES])
def test_the_port_offers_the_references_public_names(rel):
    top = rel.parts[0] if rel.parts else ""
    port_init = _ROOT / _PORT / rel / "__init__.py"
    if not port_init.exists():
        assert top in WAITING_PACKAGES, f"{rel}: no port package"
        return
    names = _public(_ROOT / _REF / rel / "__init__.py")
    waiting, _ = WAITING.get(_dotted(rel), (set(), None))
    mod = importlib.import_module(".".join([_PORT, *rel.parts]))
    missing = []
    for n in sorted(names - waiting):
        if hasattr(mod, n):
            continue
        try:
            importlib.import_module(f"{mod.__name__}.{n}")
        except ImportError:
            missing.append(n)
    assert not missing, f"{rel or 'root'} lacks {missing}"
    assert not (waiting & set(getattr(mod, "__all__", ()))), \
        "a listed name is exported: take it off the list"


@pytest.mark.parametrize("rel", [r for r in _PACKAGES
                                 if (_ROOT / _PORT / r).exists()],
                         ids=lambda r: str(r) or "root")
def test_every_exported_name_imports(rel):
    mod = importlib.import_module(".".join([_PORT, *rel.parts]))
    for n in getattr(mod, "__all__", ()):
        assert hasattr(mod, n), f"{mod.__name__}.{n}"


@pytest.mark.parametrize("pkg", ["zoo", "modelimport"])
def test_zoo_and_modelimport_export_the_references_names(pkg):
    want = _public(_ROOT / _REF / pkg / "__init__.py")
    got = _public(_ROOT / _PORT / pkg / "__init__.py")
    assert got == want


def test_top_level_names():
    import deeplearning4j_tpu_torch as p

    assert {"INDArray", "Nd4j", "DataType", "__version__"} <= set(p.__all__)
    a = p.Nd4j.create([1.0, 2.0], device="cpu")
    assert isinstance(a, p.INDArray)
    assert p.DataType.FLOAT.name == "FLOAT"


def test_non_finite_guard_keeps_the_inputs_of_a_bad_step():
    """The reference's ``non_finite_guard`` form: a functional step whose
    loss or params go non-finite returns its inputs and ok False."""
    import torch

    from deeplearning4j_tpu_torch.runtime import non_finite_guard

    def step(params, upd, states, it, x, y, key, fm, lm):
        new = {"w": params["w"] - x}
        return new, upd, states, (new["w"] ** 2).sum()

    g = non_finite_guard(step)
    p0 = {"w": torch.tensor([1.0, 2.0])}
    p1, _, _, loss, ok = g(p0, {}, {}, 0, torch.tensor(0.5), None, None,
                           None, None)
    assert bool(ok) and torch.equal(p1["w"], torch.tensor([0.5, 1.5]))
    p2, _, _, loss, ok = g(p0, {}, {}, 0, torch.tensor(float("nan")), None,
                           None, None, None)
    assert not bool(ok) and torch.equal(p2["w"], p0["w"])


def test_sampled_onehot_feedback_is_the_references():
    import numpy as np

    from deeplearning4j_tpu.serving.sampling import \
        sampled_onehot_feedback as ref
    from deeplearning4j_tpu.serving.sampling import \
        temperature_sampler as ref_sampler
    from deeplearning4j_tpu_torch.serving import (
        sampled_onehot_feedback, stream_rng, temperature_sampler,
    )

    rows = np.random.default_rng(0).standard_normal((6, 11))
    mine = sampled_onehot_feedback(11, temperature_sampler(0.8),
                                   stream_rng(3, 1))
    theirs = ref(11, ref_sampler(0.8), np.random.default_rng((3, 1)))
    for r in rows:
        np.testing.assert_array_equal(mine(r), theirs(r))


# ----------------------------------------------------------------------
# fault 3: messages that name their item
# ----------------------------------------------------------------------

def _serde_refusal():
    from deeplearning4j_tpu_torch.util import serde

    serde.decode({"__o": "deeplearning4j_tpu.parallel.costmodel:"
                         "ChipSpec", "attrs": {}}, [])


DEFERRED = {
    "serde": (_serde_refusal, r"item 7's\)"),
}


@pytest.mark.parametrize("what", sorted(DEFERRED))
def test_deferred_features_name_their_item(what):
    call, item = DEFERRED[what]
    with pytest.raises(NotImplementedError, match=item):
        call()


def test_distribute_runs():
    """``INDArray.distribute`` (item 12c, ported) places the array over a
    mesh: a one-rank mesh's block is the whole array, and a decoded
    reference ``DistributedMatrix`` names the port's class."""
    from deeplearning4j_tpu_torch.linalg import DistributedMatrix, gram
    from deeplearning4j_tpu_torch.ndarray import Nd4j
    from deeplearning4j_tpu_torch.parallel import build_mesh
    from deeplearning4j_tpu_torch.util import serde

    import numpy as np

    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    dm = Nd4j.create(a, device="cpu").distribute(build_mesh())
    assert isinstance(dm, DistributedMatrix) and dm.spec == ("data", None)
    np.testing.assert_array_equal(gram(dm).toNumpy(), a.T @ a)
    obj = serde.decode({"__o": "deeplearning4j_tpu.linalg.distributed:"
                               "DistributedMatrix", "attrs": {}}, [])
    assert type(obj) is DistributedMatrix


def test_no_message_in_the_port_names_item_12c():
    """Item 12c (``linalg/``) is ported: no file of the port names it."""
    bad = []
    for path in sorted((_ROOT / _PORT).rglob("*.py")):
        text = path.read_text()
        for m in re.finditer(r"12c", text):
            bad.append(f"{path.relative_to(_ROOT)}:"
                       f"{text.count(chr(10), 0, m.start()) + 1}")
    assert not bad, bad


def test_docstrings_name_the_items_that_hold_them():
    import deeplearning4j_tpu_torch
    from deeplearning4j_tpu_torch.ops import pooling

    # the pooling knobs are ported: the docstring names them, no item
    assert "set_maxpool_bwd" in pooling.__doc__ \
        and "item 13" not in pooling.__doc__ and "item 3)" not in pooling.__doc__
    doc = deeplearning4j_tpu_torch.__doc__
    for feature in ("one-shot serving", "ONNX import", "nn.objdetect",
                    "modelimport.keras", "modelimport.tensorflow"):
        assert feature in doc, feature


def test_no_message_in_the_port_names_item_12_for_a_ported_feature():
    """Item 12a is ported; the port names item 12 only as 12b, and the
    importers' stub ``_item12`` is gone."""
    bad = []
    for path in sorted((_ROOT / _PORT).rglob("*.py")):
        text = path.read_text()
        for m in re.finditer(r"item 12(?![bc])", text):
            line = text.count("\n", 0, m.start()) + 1
            bad.append(f"{path.relative_to(_ROOT)}:{line}")
    assert not bad, bad
    import deeplearning4j_tpu_torch.modelimport as mi

    assert not hasattr(mi, "_item12")


def test_item_7_messages_name_what_still_waits():
    """What ROADMAP Queue 1 item 7 still holds: ParallelInference's
    replica split over cards, EarlyStoppingParallelTrainer, the NCCL
    capture of a multi-rank step (the overlap planner and cost model have
    no port module to raise from). Every refusal naming item 7 names one
    of them, and the mesh axes it no longer holds run."""
    import torch

    from deeplearning4j_tpu_torch.nn import (
        DenseLayer, InputType, MultiLayerNetwork, NeuralNetConfiguration,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.optimize.earlystopping import \
        EarlyStoppingParallelTrainer
    from deeplearning4j_tpu_torch.parallel import (
        ParallelInference, build_mesh, hybrid_mesh,
    )

    net = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(1).list()
        .layer(DenseLayer(nOut=4))
        .layer(OutputLayer(nOut=2, activation="softmax"))
        .setInputType(InputType.feedForward(3)).build(),
        device="cpu").init()
    pieces = {"replica split": lambda: ParallelInference(
                  net, mesh=[torch.device("cpu")] * 2),
              "EarlyStoppingParallelTrainer":
                  lambda: EarlyStoppingParallelTrainer(None, net, None)}
    for piece, call in pieces.items():
        with pytest.raises(NotImplementedError, match="item 7") as e:
            call()
        assert piece in str(e.value)
    port = _ROOT / _PORT
    for path in sorted(port.rglob("*.py")):
        for line in path.read_text().splitlines():
            if "item 7" in line and "NotImplementedError" in line:
                pytest.fail(f"{path}: {line.strip()}")
    assert build_mesh({"data": 1, "model": 1, "seq": 1}).shape == {
        "data": 1, "model": 1, "seq": 1}
    assert hybrid_mesh({"data": 1}, {"pipe": 1}).shape == {"data": 1,
                                                           "pipe": 1}
