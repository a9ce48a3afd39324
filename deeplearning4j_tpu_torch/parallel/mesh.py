"""The data-parallel group: the port's one-axis mesh.

The counterpart of ``deeplearning4j_tpu/parallel/mesh.py``. The reference
is one process driving a ``jax.sharding.Mesh`` of named axes; the port
is one process per rank over ``torch.distributed``, so its mesh is the
default process group seen from this rank: a ``DataGroup`` holding the
rank, the world size, the backend, the process group and, under NCCL,
this rank's card. ``build_mesh``/``data_parallel_mesh`` take a pure
data axis; the model, sequence and pipeline axes wait for ROADMAP Queue
1 item 7 and raise naming it. The hierarchical exchange factors the
data axis into subgroups over GROUP_AXIS and INTRA_AXIS
(``sharding.hierarchical_mesh``).

When ``torch.distributed`` is not initialised the group is this one
process (size 1, no process group) and every collective is the identity,
so a data-parallel trainer runs on one card with no set-up, as the
reference's does on one chip.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel import collectives as _coll

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "PIPE_AXIS", "GROUP_AXIS",
           "INTRA_AXIS", "DataGroup", "build_mesh", "data_parallel_mesh"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
GROUP_AXIS = "group"
INTRA_AXIS = "intra"


def later(what):
    return NotImplementedError(
        f"{what} waits for the rest of the data-parallel slice "
        "(ROADMAP.md Queue 1 item 7)")


class DataGroup:
    """One rank's view of the data axis: ``rank``, ``size`` (the world),
    ``backend`` ("nccl", "gloo" or None), ``pg`` (the process group, None
    at world size 1 without ``torch.distributed``) and ``device`` (this
    rank's card under NCCL; None where the backend takes any device)."""

    def __init__(self, rank=0, size=1, backend=None, pg=None, device=None):
        self.rank, self.size = int(rank), int(size)
        self.backend, self.pg, self.device = backend, pg, device

    @property
    def shape(self):
        """{axis: size}, as the reference's ``Mesh.shape``."""
        return {DATA_AXIS: self.size}

    def all_reduce_sum(self, t):
        """`t` summed in place over the ranks (the BN group interface of
        ``ops.norm.sync_batch_norm``)."""
        return _coll.all_reduce(t, self)

    def __repr__(self):
        return (f"DataGroup(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}, device={self.device})")


def _default_group():
    if not (dist.is_available() and dist.is_initialized()):
        return DataGroup()
    backend = dist.get_backend()
    device = None
    if backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    return DataGroup(dist.get_rank(), dist.get_world_size(), backend,
                     dist.group.WORLD, device)


def build_mesh(axes=None):
    """build_mesh({"data": n}) -> the DataGroup of the default process
    group; n may be -1 (the world size) and must otherwise equal it: a
    rank cannot sit out of the data axis here. Any other axis raises
    NotImplementedError (item 7)."""
    g = _default_group()
    axes = {DATA_AXIS: g.size} if axes is None else dict(axes)
    other = [a for a in axes if a != DATA_AXIS]
    if other:
        raise later(f"mesh axes {other} (tensor, sequence and pipeline "
                    "parallelism)")
    n = axes.get(DATA_AXIS, g.size)
    if n == -1:
        n = g.size
    if n > g.size:
        raise ValueError(f"Mesh {{'data': {n}}} needs {n} ranks, have "
                         f"{g.size}")
    if n != g.size:
        raise ValueError(
            f"Mesh {{'data': {n}}} over a world of {g.size}: the port's "
            "data axis is the whole process group, one rank a process; "
            f"start {n} ranks instead")
    return g


def data_parallel_mesh(n=None):
    """The data axis over every rank (``n`` must be None or the world
    size)."""
    return build_mesh({DATA_AXIS: -1 if n is None else int(n)})
