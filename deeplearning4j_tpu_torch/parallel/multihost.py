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

``hybrid_mesh`` (slices x axes) waits for ROADMAP Queue 1 item 7.
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
           "launch"]


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


def hybrid_mesh(dcn_axes, ici_axes, devices=None):
    raise _mesh.later("hybrid_mesh (axes over slices and within them)")


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
