"""Tree helpers shared across the port."""

from __future__ import annotations

import torch


def device_copy_tree(tree):
    """A copy of nested dicts, lists and tuples in which every tensor leaf
    is cloned on its own device (detached, no host round trip); other
    leaves are kept as they are.

    Needed wherever saved parameters must outlive training steps: the
    port's updaters write parameters in place (``p.sub_(...)`` in
    ``nn/multilayer.py``), so a snapshot that holds references would
    follow the live network."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: device_copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(device_copy_tree(v) for v in tree)
    return tree
