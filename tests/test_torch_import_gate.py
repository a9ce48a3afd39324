"""Import gate for the port: no module of deeplearning4j_tpu_torch/ and
not chip_smoke.py imports jax, jaxlib or the JAX package
(deeplearning4j_tpu and its submodules), and no module of the package
imports ml_dtypes, scipy or tensorflow (the card's machine has neither
ml_dtypes nor tensorflow; scipy stays off the runtime path), by an AST
walk of every source file — the shape of tests/test_telemetry.py's
no-jax gate. Module names are matched exactly, so
``deeplearning4j_tpu_torch`` itself passes. The walk covers every
subpackage, ``modelimport/``, ``analysis/``, ``nlp/``, ``clustering/``,
``graph/``, ``plot/``, ``rl/`` and ``arbiter/`` included. ``h5py`` is
imported by the package only inside the calls that read a Keras file,
never at a module's top level; ``chip_smoke.py`` and the test helpers it
loads on the card's machine (``tests/_torch_{onnx,keras,tf}_models.py``)
import neither ``tensorflow`` nor ``h5py``."""

import ast
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parent.parent
_FORBIDDEN = {"jax", "jaxlib", "deeplearning4j_tpu"}
#: off the package's runtime path too (chip_smoke.py checks betainc
#: against scipy on the host)
_PACKAGE_FORBIDDEN = _FORBIDDEN | {"ml_dtypes", "scipy", "tensorflow"}
_SOURCES = sorted((_ROOT / "deeplearning4j_tpu_torch").rglob("*.py")) \
    + [_ROOT / "chip_smoke.py"]
#: loaded by chip_smoke.py on the card's machine, which has neither
#: tensorflow nor h5py
_CARD_HELPERS = [_ROOT / "tests" / f"_torch_{m}_models.py"
                 for m in ("onnx", "keras", "tf")]
_CARD_FORBIDDEN = _PACKAGE_FORBIDDEN | {"h5py"}


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def _top_level_roots(tree):
    """The roots imported outside any function body."""
    def walk(node, in_fn):
        for child in ast.iter_child_nodes(node):
            fn = in_fn or isinstance(child, (ast.FunctionDef,
                                             ast.AsyncFunctionDef,
                                             ast.Lambda))
            if not fn and isinstance(child, ast.Import):
                for a in child.names:
                    yield a.name.split(".")[0], child.lineno
            elif not fn and isinstance(child, ast.ImportFrom) \
                    and child.level == 0:
                yield (child.module or "").split(".")[0], child.lineno
            yield from walk(child, fn)
    return list(walk(tree, False))


def test_gate_covers_the_port():
    names = {p.name for p in _SOURCES}
    assert {"chip_smoke.py", "paged_attention.py", "transformer.py",
            "sequence.py", "server.py", "flash_attention.py", "attention.py",
            "graph.py", "layers.py", "updaters.py", "losses.py",
            "dtype.py", "conv.py", "pooling.py", "norm.py", "multilayer.py",
            "dataset.py", "models.py", "rnn.py", "recurrent.py",
            "trainer.py", "collectives.py", "multihost.py", "sharding.py",
            "spark.py", "dryrun.py", "mesh.py", "constraint.py",
            "weightnoise.py", "variational.py", "preprocessors.py",
            "onnx.py", "onnx_wire.py", "samediff_check.py",
            "diagnostics.py", "samediff.py", "ops_impl.py", "keras.py",
            "tensorflow.py", "tf_wire.py", "objdetect.py",
            "pretrained.py", "word2vec.py", "glove.py", "fasttext.py",
            "tokenization.py", "query.py", "vectorizers.py",
            "cnn_sentence.py", "kmeans.py", "trees.py", "lsh.py",
            "deepwalk.py", "tsne.py", "draws.py", "qlearning.py",
            "a3c.py", "async_nstep.py", "gym.py", "spaces.py",
            "layerspace.py", "profiler.py", "workspace.py",
            "pytree.py", "aot.py", "autotune.py", "retrace.py",
            "hbm_ledger.py", "hbm.py", "entry.py"} <= names
    dirs = {p.parent.name for p in _SOURCES}
    assert {"ops", "nn", "conf", "data", "zoo", "serving",
            "parallel", "modelimport", "analysis", "autodiff", "nlp",
            "clustering", "graph", "plot", "rl", "arbiter",
            "runtime", "util"} <= dirs
    assert all(p.exists() for p in _SOURCES)


@pytest.mark.parametrize("path", _SOURCES,
                         ids=[str(p.relative_to(_ROOT)) for p in _SOURCES])
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    banned = _FORBIDDEN | {"tensorflow", "h5py"} \
        if path.name == "chip_smoke.py" else _PACKAGE_FORBIDDEN
    bad = [(mod, line) for mod, line in _imported_roots(tree)
           if mod in banned]
    assert not bad, f"{path.relative_to(_ROOT)} imports {bad}"
    top = [(mod, line) for mod, line in _top_level_roots(tree)
           if mod == "h5py"]
    assert not top, f"{path.relative_to(_ROOT)} imports h5py at top level"


@pytest.mark.parametrize("path", _CARD_HELPERS,
                         ids=[p.name for p in _CARD_HELPERS])
def test_card_helpers_need_no_jax_tensorflow_or_h5py(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(mod, line) for mod, line in _imported_roots(tree)
           if mod in _CARD_FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_gate_catches_what_it_must():
    """The matcher flags the forbidden roots and only them."""
    src = ("import jax.numpy\nfrom jaxlib import x\n"
           "from deeplearning4j_tpu.serving import y\n"
           "import deeplearning4j_tpu_torch\nimport jaxtyping\n")
    flagged = [m for m, _ in _imported_roots(ast.parse(src))
               if m in _FORBIDDEN]
    assert flagged == ["jax", "jaxlib", "deeplearning4j_tpu"]
    src = ("import h5py\ndef f():\n    import h5py\n"
           "class K:\n    def g(self):\n        from h5py import File\n"
           "    import tensorflow\n")
    assert [m for m, _ in _top_level_roots(ast.parse(src))] == \
        ["h5py", "tensorflow"]
