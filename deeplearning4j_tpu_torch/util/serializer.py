"""ModelSerializer: save and restore networks and full training state.

The counterpart of ``deeplearning4j_tpu/util/serializer.py`` (reference:
org.deeplearning4j.util.ModelSerializer writeModel / restore*, with the
updater state and an optional attached normalizer, and the full training
checkpoint). The format is the reference's: one ``.npz`` holding a JSON
manifest (the configuration and structure through ``util.serde``'s
tagged codec, with the reference's module names) plus the array table
``arr_<i>``. Parameters, layer states (BN's running statistics) and the
updater's moments are stored in the reference's layouts and containers
(``NetworkRuntime.reference_state``: a conv weight HWIO, Nesterovs'
momentum and Adam's m/v in their weight's layout), so a file written by
either package restores in the other, with or without the updater.
Restoring builds the network on ``device`` (the card unless the caller
asks for the CPU) through ``initFrom``, without a random init.
"""

from __future__ import annotations

import json

import numpy as np

from deeplearning4j_tpu_torch.nn.multilayer import tree_leaves
from deeplearning4j_tpu_torch.util import serde

__all__ = ["ModelSerializer", "TrainingCheckpoint", "tree_leaves"]


def _model_type(net):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    return ("ComputationGraph" if isinstance(net, ComputationGraph)
            else "MultiLayerNetwork")


def _net_payload(net, saveUpdater: bool) -> dict:
    ref = net.reference_state(saveUpdater)
    return {
        "conf": net.conf,
        "params": ref["params"],
        "states": ref["states"],
        "upd_states": ref.get("upd_states"),
        "bias_upd_states": ref.get("bias_upd_states"),
        "iteration": net._iteration,
        "epoch": net._epoch,
    }


def _norm_path(path) -> str:
    """np.savez appends '.npz' to extensionless paths; mirror that on load
    so save(p) / load(p) agree for any p."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _save_npz(path, manifest: dict, arrays: list):
    np.savez_compressed(_norm_path(path), manifest=np.frombuffer(
        json.dumps(manifest).encode(), np.uint8),
        **{f"arr_{i}": a for i, a in enumerate(arrays)})


def _load_npz(path):
    z = np.load(_norm_path(path), allow_pickle=False)
    manifest = json.loads(bytes(z["manifest"]).decode())
    n = sum(1 for k in z.files if k.startswith("arr_"))
    arrays = [z[f"arr_{i}"] for i in range(n)]
    return manifest, arrays


def build_net(model_type, conf, device=None):
    """An uninitialised network of `model_type` over `conf`."""
    if model_type == "ComputationGraph":
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        return ComputationGraph(conf, device=device)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork(conf, device=device)


class ModelSerializer:
    @staticmethod
    def writeModel(net, path, saveUpdater: bool = True, normalizer=None):
        """Reference: ModelSerializer.writeModel(model, file, saveUpdater
        [, dataNormalization])."""
        arrays: list = []
        manifest = {
            "format": 1,
            "model_type": _model_type(net),
            "net": serde.encode(_net_payload(net, saveUpdater), arrays),
            "normalizer": (serde.encode(normalizer, arrays)
                           if normalizer is not None else None),
        }
        _save_npz(path, manifest, arrays)

    # -- restore -------------------------------------------------------
    @staticmethod
    def _restore(path, expect_type: str, loadUpdater: bool, loaded=None,
                 device=None):
        manifest, arrays = loaded if loaded is not None else _load_npz(path)
        if manifest["model_type"] != expect_type:
            raise ValueError(f"{path} holds a {manifest['model_type']}, "
                             f"not a {expect_type}")
        payload = serde.decode(manifest["net"], arrays)
        net = build_net(expect_type, payload["conf"], device)
        upd = payload["upd_states"] if loadUpdater else None
        net.initFrom(*net.from_reference_state(
            payload["params"], payload["states"], upd,
            payload.get("bias_upd_states")))
        net._iteration = payload["iteration"]
        net._epoch = payload["epoch"]
        return net

    @staticmethod
    def restore(path, loadUpdater: bool = True, device=None):
        """Type-dispatching restore: returns whichever network class the
        file holds."""
        loaded = _load_npz(path)
        return ModelSerializer._restore(path, loaded[0]["model_type"],
                                        loadUpdater, loaded=loaded,
                                        device=device)

    @staticmethod
    def restoreMultiLayerNetwork(path, loadUpdater: bool = True,
                                 device=None):
        return ModelSerializer._restore(path, "MultiLayerNetwork",
                                        loadUpdater, device=device)

    @staticmethod
    def restoreComputationGraph(path, loadUpdater: bool = True, device=None):
        return ModelSerializer._restore(path, "ComputationGraph",
                                        loadUpdater, device=device)

    @staticmethod
    def restoreNormalizer(path):
        manifest, arrays = _load_npz(path)
        if manifest.get("normalizer") is None:
            return None
        return _numpy_state(serde.decode(manifest["normalizer"], arrays))

    @staticmethod
    def addNormalizerToModel(path, normalizer):
        """Attach a fitted normalizer to an existing model file."""
        manifest, arrays = _load_npz(path)
        manifest["normalizer"] = serde.encode(normalizer, arrays)
        _save_npz(path, manifest, arrays)


def _numpy_state(obj):
    """A decoded normalizer with its statistics back as numpy arrays (the
    codec decodes arrays to tensors; normalizers work in numpy)."""
    import torch

    for k, v in vars(obj).items():
        if isinstance(v, torch.Tensor):
            setattr(obj, k, v.numpy())
    return obj


class TrainingCheckpoint:
    """The full training checkpoint (reference: TrainingCheckpoint):
    model, updater and iteration/epoch, everything a bitwise resume
    needs (dropout draws from keys of the seed and the iteration, so no
    RNG stream rides along)."""

    @staticmethod
    def save(net, path, normalizer=None, extra: dict = None):
        arrays: list = []
        manifest = {
            "format": 1,
            "checkpoint": True,
            "model_type": _model_type(net),
            "net": serde.encode(_net_payload(net, True), arrays),
            "normalizer": (serde.encode(normalizer, arrays)
                           if normalizer is not None else None),
            "extra": extra or {},
        }
        _save_npz(path, manifest, arrays)

    @staticmethod
    def load(path, device=None):
        """Returns (net, normalizer, extra)."""
        loaded = _load_npz(path)
        manifest, arrays = loaded
        net = ModelSerializer._restore(path, manifest["model_type"], True,
                                       loaded=loaded, device=device)
        norm = (_numpy_state(serde.decode(manifest["normalizer"], arrays))
                if manifest.get("normalizer") is not None else None)
        return net, norm, manifest.get("extra", {})
