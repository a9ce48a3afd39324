"""Tagged-tree codec: configuration object graphs <-> JSON + array table.

The counterpart of ``deeplearning4j_tpu/util/serde.py``, in the same
format, so a configuration or a model file written by either package
reads in the other. Configs are plain Python objects (layer configs,
updaters, schedules, vertices) whose attributes are primitives, tuples,
dicts, other config objects or arrays. ``encode`` walks the graph into a
JSON-able tree; arrays (tensors or numpy) go to a side table and are
replaced by ``{"__a": index}``; an object becomes ``{"__o":
"module:qualname", "attrs": {...}}``. Decoding instantiates classes from
inside this package only, so loading a file never runs pickled code.

Module names are written as the reference's (``deeplearning4j_tpu.nn.
conf.layers:ConvolutionLayer``): the port's modules mirror the
reference's paths, so ``_ref_module`` swaps the package prefix one way
and ``_port_module`` the other, by exact package match (``_in_pkg``).
Where a port config may lack an attribute the reference's carries
(``_ref_defaults``), ``encode`` writes the reference's default. Arrays decode to
CPU tensors (bf16 bit for bit); a network moves them to its device.
"""

from __future__ import annotations

import importlib
import json
import types

import numpy as np
import torch

__all__ = ["encode", "decode", "to_json", "from_json"]

_PKG = "deeplearning4j_tpu"
_PORT = "deeplearning4j_tpu_torch"


def _in_pkg(mod_name: str, pkg: str = _PKG) -> bool:
    # exact-package check: "deeplearning4j_tpu_evil" must NOT pass
    return mod_name == pkg or mod_name.startswith(pkg + ".")


def _ref_module(mod_name: str) -> str:
    return _PKG + mod_name[len(_PORT):]


def _port_module(mod_name: str) -> str:
    return _PORT + mod_name[len(_PKG):]


#: attributes the reference's network configs carry that a port config
#: may lack (one decoded from a file the port wrote before it had them):
#: the default ``encode`` writes
_NET_EXTRA = {"activationCheckpointing": False}


def _waits_for(mod_name):
    return "the classes that wait are ROADMAP.md Queue 1 item 7's"


def _ref_defaults(obj):
    from deeplearning4j_tpu_torch.nn.conf.builder import \
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.conf.graph import \
        ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import GlobalPoolingLayer

    if isinstance(obj, (MultiLayerConfiguration,
                        ComputationGraphConfiguration)):
        return _NET_EXTRA
    if isinstance(obj, GlobalPoolingLayer):
        return {"_mode": None}
    return {}


def _to_numpy(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        # numpy has no bf16 here: widened to float32, exactly
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def encode(obj, arrays: list):
    """Recursively encode; tensors and numpy arrays land in `arrays`."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        arrays.append(_to_numpy(obj))
        return {"__a": len(arrays) - 1}
    if isinstance(obj, list):
        return [encode(v, arrays) for v in obj]
    if isinstance(obj, tuple):
        return {"__t": [encode(v, arrays) for v in obj]}
    if isinstance(obj, (set, frozenset)):
        # sorted for deterministic output (members are config scalars)
        return {"__s": [encode(v, arrays) for v in sorted(obj, key=repr)]}
    if isinstance(obj, dict):
        return {"__d": [[encode(k, arrays), encode(v, arrays)]
                        for k, v in obj.items()]}
    from deeplearning4j_tpu_torch.ndarray.dtype import DataType

    if isinstance(obj, DataType):
        return {"__dt": obj.name}
    if isinstance(obj, (types.FunctionType, types.LambdaType,
                        types.BuiltinFunctionType, types.MethodType)):
        raise TypeError(
            "cannot serialize a Python function inside a network config: "
            "custom-code layers have no portable serialized form. Rebuild "
            "the net from code and restore the trained weights with "
            "initFrom / ModelSerializer's params-only path")
    cls = type(obj)
    if not _in_pkg(cls.__module__, _PORT):
        raise TypeError(f"cannot serialize {cls.__module__}.{cls.__name__}: "
                        f"only {_PORT} config objects are supported")
    attrs = {k: encode(v, arrays) for k, v in vars(obj).items()}
    for k, default in _ref_defaults(obj).items():
        attrs.setdefault(k, encode(default, arrays))
    return {"__o": f"{_ref_module(cls.__module__)}:{cls.__qualname__}",
            "attrs": attrs}


def decode(node, arrays):
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if isinstance(node, list):
        return [decode(v, arrays) for v in node]
    if "__a" in node:
        from deeplearning4j_tpu_torch.nn.multilayer import _tensor

        return _tensor(arrays[node["__a"]])
    if "__t" in node:
        return tuple(decode(v, arrays) for v in node["__t"])
    if "__s" in node:
        return {decode(v, arrays) for v in node["__s"]}
    if "__d" in node:
        return {decode(k, arrays): decode(v, arrays) for k, v in node["__d"]}
    if "__dt" in node:
        from deeplearning4j_tpu_torch.ndarray.dtype import DataType

        return DataType._registry[node["__dt"]]
    if "__o" in node:
        mod_name, qual = node["__o"].split(":")
        if not _in_pkg(mod_name):
            raise ValueError(f"refusing to instantiate {node['__o']}: "
                             f"outside {_PKG}")
        try:
            target = importlib.import_module(_port_module(mod_name))
            for part in qual.split("."):
                target = getattr(target, part)
        except (ImportError, AttributeError):
            raise NotImplementedError(
                f"{node['__o']}: the port has no such class yet ("
                f"{_waits_for(mod_name)})") from None
        obj = object.__new__(target)
        attrs = {k: decode(v, arrays) for k, v in node["attrs"].items()}
        obj.__dict__.update(attrs)
        return obj
    raise ValueError(f"unknown node {node!r}")


def to_json(obj) -> str:
    """Array-free JSON for configuration objects (shared by
    MultiLayerConfiguration.toJson / ComputationGraphConfiguration.toJson)."""
    arrays: list = []
    tree = encode(obj, arrays)
    if arrays:
        raise ValueError("configuration unexpectedly contains arrays")
    return json.dumps(tree)


def from_json(text: str, expected_cls=None):
    obj = decode(json.loads(text), [])
    if expected_cls is not None and not isinstance(obj, expected_cls):
        raise TypeError(f"JSON holds a {type(obj).__name__}, expected "
                        f"{expected_cls.__name__}")
    return obj
