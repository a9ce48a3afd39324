"""The device mesh: named axes over the ranks of the process group.

The counterpart of ``deeplearning4j_tpu/parallel/mesh.py``. The reference
is one process driving a ``jax.sharding.Mesh`` of named axes; the port
is one process per rank over ``torch.distributed``, so its mesh is the
default process group seen from this rank:

* a pure data axis (``build_mesh({"data": n})``, ``data_parallel_mesh``)
  is a ``DataGroup`` holding the rank, the world size, the backend, the
  process group and, under NCCL, this rank's card;
* any other axis ("model", "seq", "pipe", beside "data") gives a
  ``Mesh``: the ranks laid out row-major over the axes, the LAST axis
  innermost (contiguous ranks, as the reference's docstring puts the
  axes that talk most), this rank's coordinate on each axis, and for
  each axis the ``DataGroup`` of the ranks that differ from this one only
  on that axis, so ``collectives.*`` take it unchanged (its ``shape`` is
  ``{axis: size}``, which the collective signature records).

Stated deviation: one rank a process, so the product of the axis sizes
must equal the world size (the reference takes the first devices of a
larger set). The hierarchical exchange factors the data axis into
subgroups over GROUP_AXIS and INTRA_AXIS (``sharding.hierarchical_mesh``).

When ``torch.distributed`` is not initialised the group is this one
process (size 1, no process group) and every collective is the identity,
so a data-parallel trainer runs on one card with no set-up, as the
reference's does on one chip.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel import collectives as _coll

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "PIPE_AXIS", "GROUP_AXIS",
           "INTRA_AXIS", "DataGroup", "Mesh", "AxisGroup", "build_mesh",
           "data_parallel_mesh", "replicated", "batch_sharded", "axis_group"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
GROUP_AXIS = "group"
INTRA_AXIS = "intra"


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


class AxisGroup(DataGroup):
    """The ranks that differ from this one only on axis `axis`: rank
    ``rank`` (this rank's coordinate there) of ``size``, over process
    group ``pg`` (None at size 1); ``ranks`` are their global ranks in
    coordinate order. ``shape`` is ``{axis: size}``."""

    def __init__(self, axis, rank, size, backend, pg, device, ranks):
        super().__init__(rank, size, backend, pg, device)
        self.axis = axis
        self.ranks = tuple(int(r) for r in ranks)

    @property
    def shape(self):
        return {self.axis: self.size}

    def __repr__(self):
        return (f"AxisGroup({self.axis!r}, rank={self.rank}, "
                f"size={self.size}, ranks={self.ranks})")


class Mesh:
    """This rank's view of a multi-axis mesh (module docstring):
    ``shape`` {axis: size} in the given order, ``axis_names``,
    ``grid`` (the global ranks laid over the axes, numpy), ``coords``
    {axis: this rank's index}, ``groups`` {axis: AxisGroup}; ``rank``,
    ``size``, ``backend``, ``pg`` and ``device`` are the whole world's,
    as a DataGroup's."""

    def __init__(self, grid, names, world, groups):
        self.grid = np.asarray(grid)
        self.axis_names = tuple(names)
        self.rank, self.size = world.rank, world.size
        self.backend, self.pg, self.device = (world.backend, world.pg,
                                              world.device)
        pos = np.argwhere(self.grid == self.rank)[0]
        self.coords = {a: int(i) for a, i in zip(self.axis_names, pos)}
        self.groups = groups

    @property
    def shape(self):
        return {a: int(n) for a, n in zip(self.axis_names, self.grid.shape)}

    def group(self, axis):
        """The AxisGroup of `axis` (a one-rank group when the mesh lacks
        it)."""
        if axis in self.groups:
            return self.groups[axis]
        return AxisGroup(axis, 0, 1, self.backend, None, self.device,
                         (self.rank,))

    def all_reduce_sum(self, t):
        return _coll.all_reduce(t, self)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def axis_group(mesh, axis):
    """The group of `axis` on any mesh: a Mesh's AxisGroup, a one-axis
    DataGroup itself when `axis` is its data axis, else one rank."""
    if isinstance(mesh, Mesh):
        return mesh.group(axis)
    if axis in mesh.shape:
        return mesh
    return AxisGroup(axis, 0, 1, mesh.backend, None, mesh.device,
                     (mesh.rank,))


def _axis_sizes(axes, world):
    names, sizes = list(axes), [int(v) for v in axes.values()]
    if sizes.count(-1) > 1:
        raise ValueError(f"Mesh {axes}: at most one axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if known <= 0 or world % known != 0:
            raise ValueError(
                f"Cannot infer -1 axis: {world} devices not divisible "
                f"by fixed axes product {known}")
        sizes[sizes.index(-1)] = world // known
    for n, s in zip(names, sizes):
        if s < 1:
            raise ValueError(f"Mesh {axes}: axis '{n}' has size {s}")
    total = math.prod(sizes)
    if total > world:
        raise ValueError(f"Mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {world}")
    if total != world:
        raise ValueError(
            f"Mesh {dict(zip(names, sizes))} over a world of {world}: the "
            "port's mesh is the whole process group, one rank a process; "
            f"start {total} ranks instead")
    return names, sizes


def mesh_from_grid(grid, names, world=None):
    """The Mesh of a rank grid (global ranks laid over `names`): every
    axis subgroup made with ``dist.new_group`` on every rank, for every
    axis and every position of the other axes, in one order (a rank that
    skipped one would deadlock the others)."""
    world = _default_group() if world is None else world
    grid = np.asarray(grid)
    groups = {}
    me = tuple(np.argwhere(grid == world.rank)[0])
    for ax, name in enumerate(names):
        moved = np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax])
        mine = np.moveaxis(grid, ax, -1)[me[:ax] + me[ax + 1:]]
        pg = None
        for row in moved:
            if world.pg is None or len(row) == 1:
                continue
            made = dist.new_group([int(r) for r in row])
            if world.rank in row:
                pg = made
        groups[name] = AxisGroup(name, me[ax], len(mine), world.backend,
                                 pg, world.device, mine)
    return Mesh(grid, names, world, groups)


def build_mesh(axes=None):
    """build_mesh({"data": 4, "model": 2}) -> the mesh of the default
    process group (module docstring). One axis may be -1 (the rest of
    the world). A pure data axis returns the world's DataGroup, as the
    data-parallel trainers take it; any other axis a ``Mesh``. The
    product of the sizes must equal the world size: a rank cannot sit
    out of the mesh here."""
    g = _default_group()
    axes = {DATA_AXIS: g.size} if axes is None else dict(axes)
    names, sizes = _axis_sizes(axes, g.size)
    if names == [DATA_AXIS]:
        return g
    return mesh_from_grid(np.arange(g.size).reshape(sizes), names, g)


def data_parallel_mesh(n=None):
    """The data axis over every rank (``n`` must be None or the world
    size)."""
    return build_mesh({DATA_AXIS: -1 if n is None else int(n)})


class Placement:
    """Where an array lives on a mesh (reference: a ``NamedSharding``):
    ``spec`` is a tuple of axis names or None, one a dimension; ``()``
    replicated."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, tuple(spec)

    def __repr__(self):
        return f"Placement({self.spec})"


def replicated(mesh):
    """Every rank holds the whole array (reference: ``replicated``)."""
    return Placement(mesh, ())


def batch_sharded(mesh, axis=DATA_AXIS):
    """Dimension 0 split in contiguous blocks over `axis` (reference:
    ``batch_sharded``): what ``sharding.shard_batch`` gives each rank."""
    return Placement(mesh, (axis,))
