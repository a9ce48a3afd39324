"""Import gate for the port: no module of deeplearning4j_tpu_torch/ and
not chip_smoke.py imports jax, jaxlib or the JAX package
(deeplearning4j_tpu and its submodules), by an AST walk of every source
file — the shape of tests/test_telemetry.py's no-jax gate. Module names
are matched exactly, so ``deeplearning4j_tpu_torch`` itself passes."""

import ast
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parent.parent
_FORBIDDEN = {"jax", "jaxlib", "deeplearning4j_tpu"}
_SOURCES = sorted((_ROOT / "deeplearning4j_tpu_torch").rglob("*.py")) \
    + [_ROOT / "chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_gate_covers_the_port():
    names = {p.name for p in _SOURCES}
    assert {"chip_smoke.py", "paged_attention.py", "transformer.py",
            "sequence.py", "server.py", "flash_attention.py", "attention.py",
            "graph.py", "layers.py", "updaters.py", "losses.py",
            "dtype.py", "conv.py", "pooling.py", "norm.py", "multilayer.py",
            "dataset.py", "models.py", "rnn.py", "recurrent.py",
            "trainer.py", "collectives.py", "multihost.py", "sharding.py",
            "spark.py", "dryrun.py", "mesh.py", "constraint.py",
            "weightnoise.py", "variational.py", "preprocessors.py"} <= names
    dirs = {p.parent.name for p in _SOURCES}
    assert {"ops", "nn", "conf", "data", "zoo", "serving",
            "parallel"} <= dirs
    assert all(p.exists() for p in _SOURCES)


@pytest.mark.parametrize("path", _SOURCES,
                         ids=[str(p.relative_to(_ROOT)) for p in _SOURCES])
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(mod, line) for mod, line in _imported_roots(tree)
           if mod in _FORBIDDEN]
    assert not bad, f"{path.relative_to(_ROOT)} imports {bad}"


def test_gate_catches_what_it_must():
    """The matcher flags the forbidden roots and only them."""
    src = ("import jax.numpy\nfrom jaxlib import x\n"
           "from deeplearning4j_tpu.serving import y\n"
           "import deeplearning4j_tpu_torch\nimport jaxtyping\n")
    flagged = [m for m, _ in _imported_roots(ast.parse(src))
               if m in _FORBIDDEN]
    assert flagged == ["jax", "jaxlib", "deeplearning4j_tpu"]
