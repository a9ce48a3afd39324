"""Mesh-sharded dense linear algebra: ``DistributedMatrix`` and SUMMA GEMM.

The counterpart of ``deeplearning4j_tpu/linalg/distributed.py``. The
reference places one global ``jax.Array`` over a device mesh and runs each
routine as one ``shard_map`` program; the port is one rank a process over
``torch.distributed`` (``parallel.mesh``: a mesh's axis sizes multiply to
the world size), so a ``DistributedMatrix`` is THIS rank's block of the
global matrix on this rank's device, and each routine runs the same block
program on every rank with its collectives made through
``parallel.collectives`` (recorded, counted, NCCL on the card, gloo on
the CPU). At world size 1 every group is one rank and every collective is
the identity: the routines are plain block products on one device.

Layouts (axis names are the canonical mesh axes):

  row-sharded      (row, None)  [m/R, k]    tall data matrices
  block-sharded    (row, col)   [m/R, k/C]  operands over a 2-D mesh
  replicated       (None, None) small factors (Gram, SVD bases, CG x)

Sharding never pads: an indivisible dimension raises the reference's PAR03
error. A tensor already on the block's device is taken without a copy
(this rank's block is a view of it); numpy, an INDArray's host copy or a
tensor elsewhere is sliced to this rank's block first, then moved.

GEMM is SUMMA-shaped: the stationary operand stays put, k-panels of the
moving operand rotate around the ring by ``ppermute`` (C-1 hops for C
ranks: the reference's C-th hop, which returns each panel home, is not
made) while each rank accumulates its C block in place (``addmm_``). The
transpose-fused variants reduce over the sharded row axis with one
all-reduce, or gather the small operand once, instead of forming a
transposed global operand. The local block products are ``torch.matmul``,
as the reference's are plain products outside any Pallas kernel.

Entries (``_entry``): one ``runtime.aot.CapturedStep`` per (op, mesh,
axes), one graph per shape, as the port captures a network's step. A
call at a signature never captured runs eagerly and is counted; with a
``RetraceSentinel`` installed each new signature is captured on first
sight and counted; ``precompile`` captures the warm-start set. Stated
deviations: an entry on a multi-rank mesh refuses capture (its
collectives run eagerly; NCCL capture is ROADMAP item 7's) and every
dispatch of it counts the refusal, as a multi-rank ``ParallelWrapper``
step does; so do the entries whose bodies read a value on the host (CG's
stopping test, the small factorisations' LAPACK status). A replayed
entry's output is cloned out of the graph's static buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.analysis.collectives import collective_counts
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.parallel import collectives as _coll
from deeplearning4j_tpu_torch.parallel.mesh import axis_group

#: canonical linalg placement axes: rows of a data matrix shard over the
#: data-parallel axis, columns over the model axis
ROW_AXIS = "data"
COL_AXIS = "model"

__all__ = ["DistributedMatrix", "ROW_AXIS", "COL_AXIS", "matmul", "gram",
           "covariance", "pairwise_sq_dists", "sq_dists",
           "collective_counts", "install_retrace_sentinel", "precompile"]


def _check_divisible(dim, axis, width, what):
    """The never-pad contract (PAR03), in the reference's words: uneven
    tiling would pad the trailing shard with garbage rows that would
    silently enter the reduction."""
    if dim % width != 0:
        raise ValueError(
            f"{what} dim {dim} not divisible by mesh axis '{axis}' "
            f"(size {width}): refusing to silently pad; use a dimension "
            f"that is a multiple of {width} or replicate the operand "
            "(PAR03)")


def sq_dists(a, b):
    """[n,d]x[m,d] -> [n,m] squared euclidean distances by the quadratic
    form. Its f32 precision degrades with the data's distance from the
    origin, so callers mean-centre their data first. No collectives."""
    return torch.clamp((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
                       - 2.0 * (a @ b.T), min=0.0)


def _as_tensor(data):
    """numpy / INDArray / tensor / DistributedMatrix -> a tensor (the
    global array; a DistributedMatrix is gathered)."""
    if isinstance(data, DistributedMatrix):
        return data._global()
    if isinstance(data, torch.Tensor):
        return data
    if isinstance(getattr(data, "_t", None), torch.Tensor):
        return data._t                                # an INDArray
    return torch.from_numpy(np.ascontiguousarray(
        getattr(data, "toNumpy", lambda: data)()))


def _global_tensor(data, what):
    """`data` as a 2-D tensor (``_as_tensor``), or a ValueError."""
    t = _as_tensor(data)
    if t.dim() != 2:
        raise ValueError(f"{what} must be a 2-D matrix, got shape "
                         f"{tuple(t.shape)}")
    return t


def _group(mesh, axis):
    return None if axis is None else axis_group(mesh, axis)


def _size(mesh, axis):
    return 1 if axis is None else int(mesh.shape[axis])


def _local(t, mesh, row_axis, col_axis, device):
    """This rank's block of the global `t` on `device` (module
    docstring: a view when `t` is there already)."""
    for dim, axis in ((0, row_axis), (1, col_axis)):
        if axis is not None:
            g = axis_group(mesh, axis)
            n = t.shape[dim] // g.size
            t = t.narrow(dim, g.rank * n, n)
    return t.to(device).contiguous()


def _gather_rows(t, group):
    """[m_l, n] -> [m_l * size, n]: undo a row sharding (one all-gather;
    the identity on a one-rank group)."""
    if group is None or group.pg is None:
        return t
    return _coll.all_gather(t.contiguous(), group).reshape(-1, t.shape[1])


def _gather_cols(t, group):
    """[m_l, k/C] -> [m_l, k]: undo a column sharding."""
    if group is None or group.pg is None:
        return t
    return _coll._gather_dim(t.contiguous(), group, 1)


#: a product that reduces over a block's rows sums at most this many rows
#: in one product; longer blocks are cut into chunks whose products are
#: added in place. One f32 accumulator over 2^23 positive terms drifted
#: 4.6e-4 relative (the first 2^23 x 1024 Gram on an H100); over chunks of
#: 2^16 rows each sum stays small, at the same flops and no extra buffer
ROW_CHUNK = 2 ** 16


def _row_product(a, b):
    """a^T @ b, the reduction over the rows, ROW_CHUNK rows a product."""
    out = a[:ROW_CHUNK].T @ b[:ROW_CHUNK]
    for i in range(ROW_CHUNK, a.shape[0], ROW_CHUNK):
        out.addmm_(a[i:i + ROW_CHUNK].T, b[i:i + ROW_CHUNK])
    return out


def _sum(t, group):
    """`t` (a fresh tensor) all-reduced over `group`, in place."""
    if group is None or group.pg is None:
        return t
    return _coll.all_reduce(t, group)


class DistributedMatrix:
    """A 2-D matrix block-sharded over a mesh: this rank's block
    (``tensor()``) and the global shape.

    `row_axis` / `col_axis` name the mesh axes dims 0 / 1 shard over
    (None: that dim replicated). `device`: where the block lives (default:
    the mesh's card under NCCL, else a tensor's or an INDArray's own
    device; numpy goes to the card unless ``"cpu"`` is asked for). Every
    rank of the mesh constructs it
    from the same global matrix; the math goes through the module-level
    routines.
    """

    def __init__(self, data, mesh, row_axis=ROW_AXIS, col_axis=None,
                 device=None):
        for role, axis in (("row_axis", row_axis), ("col_axis", col_axis)):
            if axis is not None and axis not in mesh.shape:
                raise ValueError(
                    f"mesh has no axis '{axis}' (axes: "
                    f"{list(mesh.shape)}); build the mesh with it or "
                    f"pass {role}=None (PAR01)")
        if row_axis is not None and row_axis == col_axis:
            raise ValueError(
                f"row_axis and col_axis are both '{row_axis}': a mesh "
                "axis can shard at most one dim (PAR01)")
        t = _global_tensor(data, "DistributedMatrix data")
        if row_axis is not None:
            _check_divisible(t.shape[0], row_axis, _size(mesh, row_axis),
                             "row")
        if col_axis is not None:
            _check_divisible(t.shape[1], col_axis, _size(mesh, col_axis),
                             "column")
        if device is None and mesh.device is not None:
            device = mesh.device
        elif device is None and isinstance(
                getattr(data, "_t", data), torch.Tensor):
            device = t.device       # a tensor's (an INDArray's, a DM's) own
        self._init(_local(t, mesh, row_axis, col_axis,
                          resolve_device(device)),
                   tuple(t.shape), mesh, row_axis, col_axis)

    def _init(self, block, shape, mesh, row_axis, col_axis):
        self._t, self._shape = block, tuple(int(s) for s in shape)
        self.mesh, self.row_axis, self.col_axis = mesh, row_axis, col_axis
        return self

    @classmethod
    def _placed(cls, block, shape, mesh, row_axis=None, col_axis=None):
        """Wrap a block a routine computed (no placement, no copy)."""
        return cls.__new__(cls)._init(block, shape, mesh, row_axis,
                                      col_axis)

    @classmethod
    def from_local(cls, block, mesh, row_axis=ROW_AXIS, col_axis=None):
        """This rank's `block` (a 2-D tensor, every rank's the same shape)
        as its part of the global matrix: how a matrix no rank could hold
        whole is built, block by block. Port-only."""
        for axis in (row_axis, col_axis):
            if axis is not None and axis not in mesh.shape:
                raise ValueError(f"mesh has no axis '{axis}' (axes: "
                                 f"{list(mesh.shape)}) (PAR01)")
        if block.dim() != 2:
            raise ValueError(f"a block must be a 2-D matrix, got shape "
                             f"{tuple(block.shape)}")
        shape = (block.shape[0] * _size(mesh, row_axis),
                 block.shape[1] * _size(mesh, col_axis))
        return cls._placed(block.contiguous(), shape, mesh, row_axis,
                           col_axis)

    # ----- metadata ---------------------------------------------------
    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._t.dtype

    @property
    def device(self):
        return self._t.device

    @property
    def spec(self):
        """(row_axis, col_axis): the reference's PartitionSpec."""
        return (self.row_axis, self.col_axis)

    def block_shape(self):
        """Per-rank block shape under this placement."""
        return (self.shape[0] // _size(self.mesh, self.row_axis),
                self.shape[1] // _size(self.mesh, self.col_axis))

    def per_chip_bytes(self):
        """Resident bytes of ONE rank's block: the operand term of the
        static PAR06 bill (linalg.plan)."""
        b = self.block_shape()
        return int(b[0]) * int(b[1]) * self._t.element_size()

    def is_replicated(self):
        return self.row_axis is None and self.col_axis is None

    # ----- conversion -------------------------------------------------
    def tensor(self):
        """This rank's block (the reference's ``jax()`` is the global
        array; here the global matrix exists only after a gather)."""
        return self._t

    def _global(self):
        t = _gather_cols(self._t, _group(self.mesh, self.col_axis))
        return _gather_rows(t, _group(self.mesh, self.row_axis))

    def toNumpy(self):
        """Gather the GLOBAL matrix to the host (every rank calls it: an
        all-gather; for small factors and test oracles)."""
        from deeplearning4j_tpu_torch.ndarray.ndarray import to_numpy

        return to_numpy(self._global())

    def toINDArray(self):
        from deeplearning4j_tpu_torch.ndarray.ndarray import INDArray

        return INDArray(self._global())

    def replicate(self):
        """-> replicated DistributedMatrix (one all-gather a sharded
        axis)."""
        if self.is_replicated():
            return self
        return DistributedMatrix._placed(self._global(), self.shape,
                                         self.mesh)

    def __repr__(self):
        return (f"DistributedMatrix{self.shape} {self.dtype} "
                f"spec={self.spec} mesh={dict(self.mesh.shape)}")


# ----------------------------------------------------------------------
# entries: one CapturedStep per (op, mesh, axes) (module docstring)
# ----------------------------------------------------------------------

_SENTINEL = None
_ENTRIES = {}

#: entries whose bodies read a value on the host, so no graph can hold
#: them
HOST_READS = {
    "lstsq": "CG reads its stopping test on the host each iteration",
    "rsvd": "the small factorisations check their LAPACK status on the "
            "host",
    "pca": "the small factorisations check their LAPACK status on the "
           "host",
}
MULTI_RANK_REFUSAL = ("a multi-rank linalg entry runs its collectives "
                      "eagerly: the NCCL capture of a multi-rank step is "
                      "ROADMAP Queue 1 item 7's")


def install_retrace_sentinel(sentinel):
    """Route every linalg entry built FROM NOW ON through `sentinel`
    (``analysis.RetraceSentinel``): each new signature is captured on
    first sight and counted. None restores plain entries. Clears the
    entry table either way, so counting starts fresh."""
    global _SENTINEL
    _SENTINEL = sentinel
    _ENTRIES.clear()


def _mesh_fingerprint(mesh):
    return "x".join(f"{k}{v}" for k, v in mesh.shape.items())


def _entry(op, mesh, axes, body):
    """The memoised CapturedStep of (op, mesh, axes) over `body`."""
    key = (op, id(mesh), _mesh_fingerprint(mesh), axes,
           _SENTINEL is not None)
    step = _ENTRIES.get(key)
    if step is None:
        from deeplearning4j_tpu_torch.runtime import aot

        step = aot.cached_jit(
            body, entry=f"linalg_{op}",
            fingerprint=f"linalg:{op}:{_mesh_fingerprint(mesh)}:{axes}")
        if mesh.pg is not None:
            step.refusal = MULTI_RANK_REFUSAL
        elif op in HOST_READS:
            step.refusal = HOST_READS[op]
        if _SENTINEL is not None and step.refusal is None:
            _SENTINEL.watch(step, op)
        _ENTRIES[key] = step
    return step


def _clone_out(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return tuple(_clone_out(o) for o in out)


def _run(step, *args):
    """Dispatch one entry: a refused entry runs eagerly and counts the
    refusal; a captured signature replays (its output cloned out of the
    static buffer); any other call runs eagerly, counted, or captures
    first under a sentinel."""
    if step.refusal is not None:
        step.uncaptured += 1
        step.cache().note_uncaptured(step.entry, "refused")
        return step._fn(*args)
    out = step(*args)
    if args[0].is_cuda and step.captured(args):
        out = _clone_out(out)
    return out


# ----------------------------------------------------------------------
# the block programs (each rank runs the same one)
# ----------------------------------------------------------------------

def _summa_2d(al, bl, rows, cols):
    """C block [m/R, n/C] for A (r,c) x B (r,c): B's k-blocks gathered
    over the rows once, A's k-panels rotated around the column ring; at
    hop s the held panel originated at column (my - s) % C, which
    selects the matching k-rows of the gathered B."""
    bk = _gather_rows(bl, rows)                       # [k, n/C]
    kc, n_cols = al.shape[1], (1 if cols is None else cols.size)
    my = 0 if cols is None else cols.rank
    acc, ah = None, al
    for s in range(n_cols):
        src = (my - s) % n_cols
        panel = bk[src * kc:(src + 1) * kc]
        if acc is None:
            acc = ah @ panel
        else:
            acc.addmm_(ah, panel)
        if s < n_cols - 1:
            ah = _coll.ppermute(ah, cols, 1)
    return acc


def _summa_1d(al, bl, rows):
    """C block [m/R, n] for A (r) x B (r): B's k-blocks rotate around the
    row ring; each hop multiplies the matching k-panel of A."""
    kr, n_rows = bl.shape[0], (1 if rows is None else rows.size)
    my = 0 if rows is None else rows.rank
    acc, bh = None, bl
    for s in range(n_rows):
        src = (my - s) % n_rows
        panel = al[:, src * kr:(src + 1) * kr]
        if acc is None:
            acc = panel @ bh
        else:
            acc.addmm_(panel, bh)
        if s < n_rows - 1:
            bh = _coll.ppermute(bh, rows, 1)
    return acc


def _summa_2d_body(mesh, r, c):
    rows, cols = _group(mesh, r), _group(mesh, c)
    return lambda al, bl: _summa_2d(al, bl, rows, cols)


def _summa_1d_body(mesh, r):
    rows = _group(mesh, r)
    return lambda al, bl: _summa_1d(al, bl, rows)


def _matmul_ta_body(mesh, r, ca, cb):
    """The ONE builder behind the "matmul_ta" entry, shared by matmul and
    precompile."""
    rows, ga, gb = _group(mesh, r), _group(mesh, ca), _group(mesh, cb)

    def body(al, bl):
        return _sum(_row_product(_gather_cols(al, ga), _gather_cols(bl, gb)),
                    rows)

    return body


def _gram_body(mesh, r, c):
    """The ONE builder behind the "gram" entry: a one-input body, so the
    column shards are gathered once (the panel gram_plan bills)."""
    rows, cols = _group(mesh, r), _group(mesh, c)

    def body(al):
        af = _gather_cols(al, cols)
        return _sum(_row_product(af, af), rows)

    return body


# ----------------------------------------------------------------------
# public routines
# ----------------------------------------------------------------------

def _require_same_mesh(a, b):
    if a.mesh is not b.mesh and dict(a.mesh.shape) != dict(b.mesh.shape):
        raise ValueError("operands live on different meshes")


def _promoted(a, b):
    """The two blocks in their promoted dtype (the reference promotes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _replicated_rhs(b, a, what):
    """A replicated right operand as a tensor on A's device."""
    t = b._global() if isinstance(b, DistributedMatrix) \
        else _global_tensor(b, what)
    return t.to(a.device)


def matmul(a, b, transpose_a=False, transpose_b=False):
    """Distributed C = op(A) @ op(B), SUMMA-style. -> DistributedMatrix.

    Layouts (R = row-axis size, C = col-axis size):

      plain        A (r,c) x B (r,c)  -> C (r,c)   2-D ring SUMMA
                   A (r)   x B (r)    -> C (r)     1-D ring SUMMA
                   A (r[,c]) x B replicated -> C (r) (k-panel partials
                   all-reduced over the col axis when A is col-sharded)
      transpose_a  A [n,k] (r[,c]) x B [n,m] (r[,c]) -> A^T B replicated
                   (one all-reduce over the sharded row axis)
      transpose_b  A [n,d] (r) x B [m,d] (r) -> A B^T (r) (one all-gather
                   of B over the row axis)

    Dimensions a layout would shard unevenly raise the PAR03 never-pad
    error before any block program runs.
    """
    if transpose_a and transpose_b:
        raise ValueError("transpose_a and transpose_b together are not "
                         "supported; transpose the small operand on host")
    if not isinstance(a, DistributedMatrix):
        raise TypeError("matmul's first operand must be a "
                        "DistributedMatrix")
    mesh, r, c = a.mesh, a.row_axis, a.col_axis
    if transpose_a:
        return _matmul_ta(a, b)
    if transpose_b:
        return _matmul_tb(a, b)
    if r is None and c is not None:
        # no SUMMA layout shards A's k alone: refusing beats mislabelling
        # a sharded result as replicated
        raise ValueError(
            f"matmul does not support column-only sharding {a.spec}; "
            "row-shard the operand (row_axis=) or replicate() it")
    if not isinstance(b, DistributedMatrix) or (
            b.is_replicated() and not a.is_replicated()):
        return _matmul_repl_b(a, _replicated_rhs(b, a, "matmul rhs"))

    _require_same_mesh(a, b)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shape mismatch: {a.shape} @ {b.shape}")
    if (b.row_axis, b.col_axis) != (r, c):
        raise ValueError(
            f"matmul needs both operands on the same layout, got "
            f"A {a.spec} vs B {b.spec}; replicate() or re-place one")
    k = a.shape[1]
    if r is not None:
        _check_divisible(k, r, _size(mesh, r), "contraction (k)")
    if c is not None:
        _check_divisible(k, c, _size(mesh, c), "contraction (k)")
    al, bl = _promoted(a.tensor(), b.tensor())
    out = (a.shape[0], b.shape[1])
    if c is not None:
        step = _entry("matmul2d", mesh, (r, c), _summa_2d_body(mesh, r, c))
    elif r is not None:
        step = _entry("matmul1d", mesh, (r,), _summa_1d_body(mesh, r))
    else:
        step = _entry("matmul_repl", mesh, (), torch.matmul)
    return DistributedMatrix._placed(_run(step, al, bl), out, mesh, r, c)


def _matmul_repl_b(a, b):
    """A (r[,c]) @ replicated B: the local product per row block; when
    A's k is col-sharded each rank multiplies its k-panel by the matching
    rows of B and the partials are all-reduced over the col axis."""
    mesh, r, c = a.mesh, a.row_axis, a.col_axis
    if a.shape[1] != b.shape[0]:
        raise ValueError(
            f"matmul shape mismatch: {a.shape} @ {tuple(b.shape)}")
    if c is None:
        step = _entry("matmul_replb", mesh, (r,), torch.matmul)
    else:
        cols = _group(mesh, c)

        def body(al, bf):
            kc = al.shape[1]
            return _sum(al @ bf[cols.rank * kc:(cols.rank + 1) * kc], cols)

        step = _entry("matmul_replb_sum", mesh, (r, c), body)
    al, bf = _promoted(a.tensor(), b)
    return DistributedMatrix._placed(_run(step, al, bf),
                                     (a.shape[0], b.shape[1]), mesh, r)


def _as_row_sharded(b, a):
    if isinstance(b, DistributedMatrix):
        return b
    return DistributedMatrix(b, a.mesh, row_axis=a.row_axis, col_axis=None,
                             device=a.device)


def _matmul_ta(a, b):
    """A^T @ B with both operands sharded over the same row axis: the
    contraction dim IS the sharded dim, so each rank's partial product
    reduces with ONE all-reduce; column shards are gathered first (the
    result is a small factor, replicated by contract)."""
    b = _as_row_sharded(b, a)
    _require_same_mesh(a, b)
    if a.shape[0] != b.shape[0]:
        raise ValueError(
            f"matmul(transpose_a) shape mismatch: {a.shape}^T @ {b.shape}")
    if a.row_axis is None or a.row_axis != b.row_axis:
        raise ValueError(
            "matmul(transpose_a) reduces over the sharded row axis: both "
            f"operands must be row-sharded over the same axis, got "
            f"A {a.spec} vs B {b.spec}")
    mesh, r, ca, cb = a.mesh, a.row_axis, a.col_axis, b.col_axis
    step = _entry("matmul_ta", mesh, (r, ca, cb),
                  _matmul_ta_body(mesh, r, ca, cb))
    al, bl = _promoted(a.tensor(), b.tensor())
    return DistributedMatrix._placed(_run(step, al, bl),
                                     (a.shape[1], b.shape[1]), mesh)


def _matmul_tb(a, b):
    """A @ B^T with both row-sharded: one all-gather of B over the row
    axis, then a local product (the all-pairs similarity pattern); the
    [n, m] result stays row-sharded."""
    b = _as_row_sharded(b, a)
    _require_same_mesh(a, b)
    if a.shape[1] != b.shape[1]:
        raise ValueError(
            f"matmul(transpose_b) shape mismatch: {a.shape} @ {b.shape}^T")
    if a.col_axis is not None or b.col_axis is not None:
        raise ValueError(
            "matmul(transpose_b) supports row-sharded operands only "
            f"(col_axis=None), got A {a.spec} vs B {b.spec}")
    if a.row_axis is None or a.row_axis != b.row_axis:
        raise ValueError(
            "matmul(transpose_b) needs both operands row-sharded over "
            f"the same axis, got A {a.spec} vs B {b.spec}")
    mesh, r = a.mesh, a.row_axis
    rows = _group(mesh, r)
    step = _entry("matmul_tb", mesh, (r,),
                  lambda al, bl: al @ _gather_rows(bl, rows).T)
    al, bl = _promoted(a.tensor(), b.tensor())
    return DistributedMatrix._placed(_run(step, al, bl),
                                     (a.shape[0], b.shape[0]), mesh, r)


def gram(a):
    """A^T A [k, k] replicated: the reduction over the sharded row axis
    (one all-reduce; column shards gathered once). The building block of
    covariance/PCA and the CG normal equations."""
    if not isinstance(a, DistributedMatrix) or a.row_axis is None:
        raise ValueError("gram needs a row-sharded DistributedMatrix "
                         "(the reduction is over the sharded row axis)")
    mesh, r, c = a.mesh, a.row_axis, a.col_axis
    step = _entry("gram", mesh, (r, c), _gram_body(mesh, r, c))
    return DistributedMatrix._placed(_run(step, a.tensor()),
                                     (a.shape[1], a.shape[1]), mesh)


def covariance(a, ddof=1):
    """Column covariance [k, k] of a row-sharded data matrix: column means
    by an all-reduce of local sums, then the centred Gram (two
    all-reduces, no global gather)."""
    if a.row_axis is None:
        raise ValueError("covariance needs a row-sharded matrix (the "
                         "reduction is over the sharded row axis)")
    mesh, r, c = a.mesh, a.row_axis, a.col_axis
    n = a.shape[0]
    if n - ddof <= 0:
        raise ValueError(f"covariance of {n} rows with ddof={ddof}")
    rows, cols = _group(mesh, r), _group(mesh, c)

    def body(al):
        af = _gather_cols(al, cols)
        ac = af - _sum(af.sum(0), rows)[None, :] / n
        return _sum(_row_product(ac, ac), rows) / (n - ddof)

    step = _entry("covariance", mesh, (r, c, int(ddof), n), body)
    return DistributedMatrix._placed(_run(step, a.tensor()),
                                     (a.shape[1], a.shape[1]), mesh)


def pairwise_sq_dists(a, b):
    """[n, d] row-sharded x [m, d] replicated -> [n, m] row-sharded
    squared euclidean distances (no collectives: the small operand is
    replicated)."""
    if a.col_axis is not None:
        raise ValueError("pairwise_sq_dists needs a row-sharded matrix "
                         "(col_axis=None); gather columns first")
    bt = _replicated_rhs(b, a, "pairwise_sq_dists rhs")
    if a.shape[1] != bt.shape[1]:
        raise ValueError(f"feature dims differ: {a.shape} vs "
                         f"{tuple(bt.shape)}")
    mesh, r = a.mesh, a.row_axis
    step = _entry("pairwise_sq_dists", mesh, (r,), sq_dists)
    al, bl = _promoted(a.tensor(), bt)
    return DistributedMatrix._placed(_run(step, al, bl),
                                     (a.shape[0], bt.shape[0]), mesh, r)


# ----------------------------------------------------------------------
# warm start
# ----------------------------------------------------------------------

def precompile(mesh, m, k, n, dtype=torch.float32, row_axis=ROW_AXIS,
               col_axis=None, device=None):
    """Capture the public entries at one GEMM problem size: matmul (the
    layout chosen from the axes), matmul_ta, gram and lstsq. Returns
    {entry: (status, seconds)}: "cold"/"warm" as ``CapturedStep.capture``
    reports, "refused" for an entry that cannot be captured (module
    docstring; the refusal is counted)."""
    from deeplearning4j_tpu_torch.linalg.solvers import _lstsq_step

    dt = dtype if isinstance(dtype, torch.dtype) else \
        torch.from_numpy(np.zeros(0, dtype)).dtype
    # the never-pad contract, checked before anything is allocated
    _check_divisible(m, row_axis, _size(mesh, row_axis), "row (m)")
    _check_divisible(k, row_axis, _size(mesh, row_axis), "contraction (k)")
    if col_axis is not None:
        _check_divisible(k, col_axis, _size(mesh, col_axis),
                         "contraction (k)")
        _check_divisible(n, col_axis, _size(mesh, col_axis), "column (n)")
    dev = resolve_device(device if device is not None else mesh.device)
    R, C = _size(mesh, row_axis), _size(mesh, col_axis)
    a = torch.zeros(m // R, k // C, dtype=dt, device=dev)
    b = torch.zeros(k // R, n // C, dtype=dt, device=dev)
    out = {}

    def warm(op, step, *args):
        if step.refusal is not None:
            step.uncaptured += 1
            step.cache().note_uncaptured(step.entry, "refused")
            out[op] = ("refused", 0.0)
            return
        _, status, secs = step.capture(args)
        out[op] = (status, round(secs, 3))

    if col_axis is not None:
        warm("matmul2d", _entry("matmul2d", mesh, (row_axis, col_axis),
                                _summa_2d_body(mesh, row_axis, col_axis)),
             a, b)
    else:
        warm("matmul1d", _entry("matmul1d", mesh, (row_axis,),
                                _summa_1d_body(mesh, row_axis)), a, b)
    warm("matmul_ta", _entry("matmul_ta", mesh,
                             (row_axis, col_axis, col_axis),
                             _matmul_ta_body(mesh, row_axis, col_axis,
                                             col_axis)), a, a)
    warm("gram", _entry("gram", mesh, (row_axis, col_axis),
                        _gram_body(mesh, row_axis, col_axis)), a)
    warm("lstsq", _lstsq_step(mesh, row_axis, None, 0.0, 1e-6,
                              max(2 * int(k), 16)),
         torch.zeros(m // R, k, dtype=dt, device=dev),
         torch.zeros(m // R, 1, dtype=dt, device=dev))
    return out
