"""Directory checkpoints with an atomic commit and a content digest.

The counterpart of ``deeplearning4j_tpu/util/sharded_checkpoint.py``,
single process. The reference writes its array state through Orbax; the
port has no Orbax, so this directory format is the port's own: a
``manifest.json`` (the serde-encoded configuration, the reference-layout
state's sha256 digest, ``extra`` resume metadata) beside ``state.npz``
(the state's leaves, ``arr_<i>`` in ``tree_leaves`` order). Neither
package reads the other's checkpoint directories; the ``.npz`` model
files of ``util.serializer`` are the format they share.

The state is ``{"params", "states", "counters", "upd_states"}`` in the
reference's layouts and containers, and ``state_digest`` hashes its
leaves in ``jax.tree_util`` order (dict keys sorted), so the same trained
state hashes the same in both packages.

Durability, as in the reference: ``writeModel`` stages everything under
a ``<path>.tmp-stage`` sibling and renames it into place only once every
byte is written, so a save killed at any point leaves the previous
complete checkpoint or none. ``latest_step`` / ``complete_steps`` /
``gc_checkpoints`` manage a directory of ``step_<n>`` checkpoints for
``runtime.resilience.ResilientFit``'s periodic save and resume.

Trainer state (a data-parallel wrapper's error-feedback residual and
tau) rides beside the net's in ``trainer.npz`` with its own digest
(``restore_trainer_state``); a ZeRO updater state is written in the
canonical full-shape layout, so a checkpoint restores into any mode and
any number of ranks.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import numpy as np

from deeplearning4j_tpu_torch.nn.multilayer import tree_items, tree_leaves
from deeplearning4j_tpu_torch.util import serde

__all__ = ["CheckpointDigestError", "state_digest", "step_path",
           "complete_steps", "latest_step", "gc_checkpoints",
           "read_manifest", "net_state", "write_state",
           "restore_trainer_state", "ShardedModelSerializer"]

_MANIFEST = "manifest.json"
_STATE = "state.npz"
_TRAINER = "trainer.npz"
_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_RE = re.compile(r"\.tmp-")


class CheckpointDigestError(ValueError):
    """The restored state does not hash to the digest its manifest
    committed with: the checkpoint is corrupt. ResilientFit treats it as
    absent and falls back to the previous snapshot."""


def state_digest(state) -> str:
    """sha256 over the state tree's leaves (dtype, shape, raw bytes) in
    ``jax.tree_util`` order, integer leaves as int64 (the reference's
    canonicalisation)."""
    h = hashlib.sha256()
    for leaf in tree_leaves(state):
        a = serde._to_numpy(leaf)
        if a.dtype.kind in "iu":
            a = np.asarray(a, np.int64)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _commit(tmp: str, final: str):
    """Rename the staged checkpoint into place. Overwriting swaps via a
    ``.old`` sibling, which ``gc_checkpoints`` does not sweep, so a crash
    inside the swap leaves a complete copy at one of the two names."""
    if os.path.isdir(final):
        trash = final + ".old"
        shutil.rmtree(trash, ignore_errors=True)
        os.rename(final, trash)
        os.rename(tmp, final)
        shutil.rmtree(trash, ignore_errors=True)
    else:
        os.rename(tmp, final)


def step_path(directory, step: int) -> str:
    """Canonical `<dir>/step_<n>` checkpoint path for iteration `step`."""
    return os.path.join(os.path.abspath(str(directory)), f"step_{int(step)}")


def complete_steps(directory):
    """Every step with a committed `step_<n>` checkpoint (its manifest
    present) under `directory`, ascending. Staged `.tmp-*` leftovers are
    never candidates."""
    directory = os.path.abspath(str(directory))
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, _MANIFEST)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory):
    """Highest complete step under `directory`, or None."""
    steps = complete_steps(directory)
    return steps[-1] if steps else None


def gc_checkpoints(directory, keepLast: int):
    """Keep the newest `keepLast` complete checkpoints and sweep `.tmp-*`
    staging leftovers; returns the deleted paths. keepLast <= 0 keeps
    every complete checkpoint."""
    directory = os.path.abspath(str(directory))
    if not os.path.isdir(directory):
        return []
    steps, deleted = [], []
    for name in os.listdir(directory):
        full = os.path.join(directory, name)
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(full, _MANIFEST)):
            steps.append((int(m.group(1)), full))
        elif _TMP_RE.search(name):
            shutil.rmtree(full, ignore_errors=True)
            deleted.append(full)
    if keepLast and keepLast > 0 and len(steps) > keepLast:
        steps.sort()
        for _, full in steps[:-keepLast]:
            shutil.rmtree(full, ignore_errors=True)
            deleted.append(full)
    return deleted


def read_manifest(path) -> dict:
    """The checkpoint's manifest.json (with any `extra` metadata)."""
    with open(os.path.join(os.path.abspath(str(path)), _MANIFEST)) as f:
        return json.load(f)


def net_state(net, saveUpdater=True):
    """The checkpointed state in the reference's layouts and containers
    (reference: ``_net_state``); a ZeRO updater state in its canonical
    layout, gathered from every rank."""
    ref = net.reference_state(saveUpdater)
    state = {"params": ref["params"], "states": ref["states"],
             "counters": {"iteration": np.asarray(net._iteration, np.int64),
                          "epoch": np.asarray(net._epoch, np.int64)}}
    if saveUpdater:
        state["upd_states"] = ref["upd_states"]
        if "bias_upd_states" in ref:    # the port's biasUpdater state
            state["bias_upd_states"] = ref["bias_upd_states"]
    return state


_net_state = net_state   # the reference's name


def _fill(template, arrays):
    """`template`'s tree with its leaves replaced, in leaf order, by
    `arrays`."""
    leaves = dict(zip((p for p, _ in tree_items(template)), arrays))

    def rebuild(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rebuild(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, path + (i,))
                              for i, v in enumerate(node))
        return leaves[path]

    return rebuild(template, ())


def _digest_arrays(arrays) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = arrays[k]
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def write_state(net, path, state, saveUpdater=True, extra=None,
                trainer_state=None):
    """Write `state` (``net_state(net, saveUpdater)``) of `net` to
    directory `path`, atomically; `trainer_state` is a flat
    {name: tensor} the trainer owns (``restore_trainer_state``). Reads
    nothing from other ranks, so a data-parallel trainer gathers the
    state on every rank and writes it from one."""
    path = os.path.abspath(str(path))
    tmp = path + ".tmp-stage"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    conf_arrays = []
    conf_node = serde.encode(net.conf, conf_arrays)
    leaves = [serde._to_numpy(a) for a in tree_leaves(state)]
    manifest = {
        "cls": type(net).__name__,
        "conf": conf_node,
        "conf_arrays": [{"dtype": str(a.dtype), "data": a.tolist()}
                        for a in conf_arrays],
        "saveUpdater": bool(saveUpdater),
        "trainerState": trainer_state is not None,
        "digest": state_digest(state),
    }
    if trainer_state is not None:
        arrays = {k: serde._to_numpy(v) for k, v in trainer_state.items()}
        manifest["trainerDigest"] = _digest_arrays(arrays)
        np.savez(os.path.join(tmp, _TRAINER), **arrays)
    if extra is not None:
        manifest["extra"] = extra
    np.savez(os.path.join(tmp, _STATE),
             **{f"arr_{i}": a for i, a in enumerate(leaves)})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    _commit(tmp, path)
    return path


def restore_trainer_state(path, device=None):
    """The trainer state a ``writeModel(..., trainer_state=...)`` save
    carried, as {name: CPU tensor, or on `device`}, or None when the
    checkpoint has none (reference: ``restore_trainer_state``; the
    wrapper that reads it checks the layout). Raises
    ``CheckpointDigestError`` when it fails its digest."""
    path = os.path.abspath(str(path))
    p = os.path.join(path, _TRAINER)
    if not os.path.exists(p):
        return None
    z = np.load(p, allow_pickle=False)
    arrays = {k: z[k] for k in z.files}
    want = read_manifest(path).get("trainerDigest")
    if want is not None and _digest_arrays(arrays) != want:
        raise CheckpointDigestError(
            f"checkpoint {path}: its trainer state fails digest "
            "verification")
    import torch

    return {k: torch.from_numpy(np.array(a)).to(device or "cpu")
            for k, a in arrays.items()}


class ShardedModelSerializer:
    """writeModel/restore over the directory format above (the
    counterpart of the reference's Orbax-backed class, one process)."""

    @staticmethod
    def writeModel(net, path, saveUpdater=True, extra=None,
                   trainer_state=None):
        """Save to directory `path`, atomically. `extra`: a JSON-able dict
        recorded in the manifest (read back by ``read_manifest``), so
        resume metadata commits with the state it describes.
        `trainer_state`: a flat {name: tensor} of trainer-owned step
        state (a ``ParallelWrapper``'s residual and tau), kept apart
        from the net's, which restores into any mode. A ZeRO updater
        state is written canonical (every rank of its group must
        call)."""
        return write_state(net, path, net_state(net, saveUpdater),
                           saveUpdater, extra, trainer_state)

    @staticmethod
    def restore(path, device=None):
        """Rebuild the network saved at `path` on `device` (the card
        unless the caller asks for the CPU); raises
        ``CheckpointDigestError`` when the state fails its digest."""
        from deeplearning4j_tpu_torch.util.serializer import build_net

        path = os.path.abspath(str(path))
        mpath = os.path.join(path, _MANIFEST)
        if not os.path.exists(mpath):
            raise ValueError(f"no sharded checkpoint at {path} "
                             f"(missing {_MANIFEST})")
        with open(mpath) as f:
            manifest = json.load(f)
        conf_arrays = [np.asarray(d["data"], dtype=d["dtype"])
                       for d in manifest.get("conf_arrays", [])]
        conf = serde.decode(manifest["conf"], conf_arrays)
        net = build_net(manifest["cls"], conf, device).init()
        z = np.load(os.path.join(path, _STATE), allow_pickle=False)
        arrays = [z[f"arr_{i}"] for i in range(len(z.files))]
        state = _fill(net_state(net, manifest["saveUpdater"]), arrays)
        want = manifest.get("digest")
        if want is not None:
            got = state_digest(state)
            if got != want:
                raise CheckpointDigestError(
                    f"checkpoint {path} fails digest verification "
                    f"(manifest {want[:12]}…, restored {got[:12]}…): "
                    "corrupt state must not be restored")
        net.initFrom(*net.from_reference_state(
            state["params"], state["states"], state.get("upd_states"),
            state.get("bias_upd_states")))
        net._iteration = int(state["counters"]["iteration"])
        net._epoch = int(state["counters"]["epoch"])
        return net
