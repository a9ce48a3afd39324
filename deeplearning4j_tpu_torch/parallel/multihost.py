"""Starting the ranks of a data-parallel job.

The counterpart of ``deeplearning4j_tpu/parallel/multihost.py``. The
reference joins hosts to one JAX distributed runtime and then drives
every chip from each host; the port runs one process per rank, joined
by ``torch.distributed``:

* ``initialize(...)``: this process joins the job's process group, from
  arguments or from the variables ``torchrun`` sets (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``). The backend
  follows the device: NCCL for the card (this rank's ``cuda:<local
  rank>``), gloo for the CPU; a caller may name gloo for CUDA tensors.
* ``launch(fn, world_size, ...)``: start ``world_size`` ranks on this
  machine (``spawn``), rendezvous through a ``FileStore`` in a fresh
  temporary directory (no TCP port to collide with), run
  ``fn(rank, world_size, device, *args)`` in each and return the
  results in rank order. At ``timeout`` every rank is killed and
  ``TimeoutError`` raised; a rank that raises or dies takes the others
  down with it. `fn` must be importable by the spawned ranks (a module
  function, in a module that does not import jax) and return something
  picklable (numpy arrays, not tensors).

``hybrid_mesh(dcn_axes, ici_axes)`` (reference :51-90) lays a mesh over
nodes: the DCN axes outermost over the nodes (the ranks that share a
host name), the ICI axes innermost over each node's local ranks, so the
axes that talk every layer stay inside a node. One node degrades to
``build_mesh({**dcn_axes, **ici_axes})``. ``hybrid_rank_grid`` is the
layout alone, a pure function of the axes and the nodes' ranks.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.parallel import mesh as _mesh

__all__ = ["initialize", "is_coordinator", "num_hosts", "hybrid_mesh",
           "hybrid_rank_grid", "launch"]


def _rank_device(device, local_rank):
    """The device a rank runs on: the card `local_rank` modulo the cards
    seen when `device` names CUDA without an index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, *, backend=None, device=None,
               init_method=None, timeout=1800.0):
    """Join this process to the job (reference: the Spark/Aeron cluster
    join): ``init_process_group`` with `backend` (default NCCL for a CUDA
    `device`, gloo for the CPU; `device` None means the card), rank
    `process_id` of `num_processes`, at `init_method` or
    ``tcp://<coordinator_address>`` or, with neither, the environment.
    Under CUDA the rank's card becomes the current device. Returns the
    data group (``mesh.data_parallel_mesh()``)."""
    rank = int(os.environ.get("RANK", 0)) if process_id is None \
        else int(process_id)
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if init_method is None and coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else rank,
        timeout=datetime.timedelta(seconds=float(timeout)))
    return _mesh.data_parallel_mesh()


def is_coordinator() -> bool:
    """True on rank 0, the process that writes checkpoints and logs
    (reference: the coordinating Spark process); True without a process
    group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def num_hosts() -> int:
    """The number of processes in the job (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def hybrid_rank_grid(dcn_axes, ici_axes, nodes):
    """The global ranks laid over ``dcn_axes`` then ``ici_axes`` (a numpy
    array of that shape): `nodes` lists each node's ranks, the DCN axes
    range over the nodes and the ICI axes over a node's ranks, so every
    ICI group lies inside one node. One node: the ranks row-major, as
    ``build_mesh``. Raises the reference's errors when the DCN axes ask
    for more nodes than there are, or the axes do not cover every rank."""
    import math

    import numpy as np

    dcn_total = math.prod(dcn_axes.values()) if dcn_axes else 1
    ici_total = math.prod(ici_axes.values()) if ici_axes else 1
    ranks = [r for node in nodes for r in node]
    if len(nodes) <= 1:
        if dcn_total > 1 and len(ranks) < dcn_total * ici_total:
            raise ValueError(
                f"dcn axes {dcn_axes} need {dcn_total} slices; "
                f"found {len(nodes)}")
        if dcn_total * ici_total != len(ranks):
            raise ValueError(
                f"Mesh {({**dcn_axes, **ici_axes})} needs "
                f"{dcn_total * ici_total} devices, have {len(ranks)}")
        return np.asarray(sorted(ranks)).reshape(
            list(dcn_axes.values()) + list(ici_axes.values()))
    if dcn_total * ici_total != len(ranks) or dcn_total != len(nodes) \
            or any(len(node) != ici_total for node in nodes):
        raise ValueError(
            f"hybrid mesh axes {dcn_axes} x {ici_axes} cover "
            f"{dcn_total * ici_total} devices but the pod has "
            f"{len(ranks)}; every in-slice chip must be covered by an ici "
            "axis (add e.g. a 'model' or inner 'data' axis)")
    grid = np.asarray([sorted(node) for node in nodes])
    return grid.reshape(list(dcn_axes.values()) + list(ici_axes.values()))


def _nodes():
    """Each node's global ranks, in node order: the ranks grouped by host
    name (``LOCAL_WORLD_SIZE`` contiguous ranks a node where the
    launcher sets it)."""
    import socket

    world = _mesh._default_group()
    if world.pg is None:
        return [[0]]
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None:
        k = int(local)
        return [list(range(i, i + k)) for i in range(0, world.size, k)]
    names = [None] * world.size
    dist.all_gather_object(names, socket.gethostname())
    order = []
    for n in names:
        if n not in order:
            order.append(n)
    return [[r for r, n in enumerate(names) if n == h] for h in order]


def hybrid_mesh(dcn_axes, ici_axes, devices=None):
    """The mesh of ``dcn_axes`` over nodes and ``ici_axes`` within each
    (module docstring): a ``parallel.mesh`` mesh (a DataGroup for a pure
    data axis). `devices` is accepted for the reference's signature;
    the port's devices are its ranks."""
    dcn_axes, ici_axes = dict(dcn_axes), dict(ici_axes)
    nodes = _nodes()
    grid = hybrid_rank_grid(dcn_axes, ici_axes, nodes)
    if len(nodes) <= 1:
        return _mesh.build_mesh({**dcn_axes, **ici_axes})
    names = list(dcn_axes) + list(ici_axes)
    return _mesh.mesh_from_grid(grid, names)


def _rank_main(fn, rank, world_size, device, backend, store_path, timeout,
               args, results):
    """One spawned rank: join the FileStore rendezvous, run `fn`, send
    (rank, "ok", result) or (rank, "error", traceback)."""
    try:
        torch.set_num_threads(1)
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size),
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            results.put((rank, "ok", fn(rank, world_size, dev, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def launch(fn, world_size, device=None, backend=None, timeout=300.0,
           args=()):
    """Run ``fn(rank, world_size, device, *args)`` on `world_size`
    spawned ranks (module docstring); returns the results in rank order.
    `device` None means the card (the card ``rank % cards`` for each
    rank); `backend` defaults to NCCL for CUDA and gloo for the CPU."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="dl4j_launch_")
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(fn, r, int(world_size), str(dev), backend,
              os.path.join(tmp, "store"), float(timeout), tuple(args),
              results)) for r in range(int(world_size))]
    deadline = time.monotonic() + float(timeout)
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < len(procs):
            try:
                rank, status, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [p for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(
                        f"rank {procs.index(dead[0])} died with exit code "
                        f"{dead[0].exitcode} before sending a result")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{len(procs)} ranks of {fn.__name__} did not "
                        f"finish in {timeout} s; killed them all")
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                   f"failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(len(procs))]
