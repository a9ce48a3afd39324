"""SameDiff graph: define-then-run symbolic autodiff over torch.

The counterpart of ``deeplearning4j_tpu/autodiff/samediff.py``
(reference: org.nd4j.autodiff.samediff.SameDiff / SDVariable /
TrainingConfig). Ops are appended in definition order, which is a
topological order, so the backward slice of any output set is a valid
program. Where the reference jits that slice into one XLA computation,
the port interprets it eagerly, one torch op per graph op on the graph's
device; gradients are ``torch.autograd`` over the same interpretation.

* ``output``/``exec``/``batchOutput`` run the slice under
  ``torch.no_grad``; ``calculateGradients``/``grad`` differentiate the
  sum of the loss variables' sums with respect to variables or
  placeholders.
* ``fit`` takes one step per batch: the loss is the sum of every marked
  loss variable's full sum, accumulated in at least fp32, plus ``l2``
  and ``l1`` over the trainable variables; ``weightDecay`` is added to
  the gradients; the update goes through
  ``nn.multilayer.default_param_update`` with the iteration counter.
  ``fitSteps(k)`` is k such steps with one loss fetch at the end.
* Stochastic ops (dropout in training, the random ops) draw from a
  ``torch.Generator`` seeded from (stream, the op's path, op index): a
  fixed stream in ``output`` and one stream per iteration in ``fit``.
  An op inside a control-flow body carries the body's path (the
  reference folds ``1_000_000 + op index``) and, in a loop, the
  iteration, so it draws afresh every iteration and never on an outer
  op's stream. The draws are reproducible per device; they never match
  the reference's threefry.
* Control flow (``ifCond``/``whileLoop``, aliases ``cond``/
  ``while_loop``): bodies are graph builders over a sub-SameDiff,
  recorded at definition so a graph with them saves and loads.
  ``ifCond`` reads its predicate on the host and runs one branch (one
  host sync, as ``lax.cond`` runs one). ``whileLoop`` with
  ``maxIterations=None`` is a Python loop with one predicate fetch an
  iteration, inference-only as the reference's ``lax.while_loop``; with
  ``maxIterations=N`` it is N masked iterations (``where(pred, new,
  old)``; the body runs on after the predicate turns false) with no host
  sync, so it trains inside ``fitSteps``/``fitDataSet`` blocks. Host
  fetches are counted in ``_control_syncs`` (and added to
  ``fitDataSet``'s ``_fit_dataset_syncs``).
* ``save``/``load`` write and read the reference's format: a zip of
  ``graph.json`` (variables with ``phShape``/``phDtype``, ops with their
  kwargs and recorded bodies, ``lossVariables``, ``iteration``),
  ``arrays.npz`` (with the bodies' constants under ``__body__/...``) and,
  with ``saveUpdaterState``, ``updater.npz`` (the updater state's leaves
  in ``jax.tree_util`` order), so a reference file loads here and a port
  file loads there (bf16 arrays are written widened to float32, complex
  ones as they are).

A graph owns its arrays: ``var``/``constant``/``setArray`` take a copy,
and ``getArr``/``output`` hand out copies of stored arrays, so ``fit``
may update its variables in place without any INDArray seeing it.

The namespaces are the reference's: ``math`` (with the segment ops and
``betainc``), ``nn``, ``cnn``, ``rnn``, ``loss``, ``image``, ``linalg``,
``bitwise``, ``random`` and ``fft``. ``shardWeightUpdate`` installs the
ZeRO update (``parallel.sharding.ZeroShardedUpdate``) over the ranks of
a data group. ``precompile`` captures the training
step as a CUDA graph (``runtime.aot``) that ``fit``, ``fitSteps`` and
``fitDataSet`` replay; a graph whose ``ifCond`` or unbounded
``whileLoop`` reads a predicate on the host, or whose random ops draw
from the step's host-seeded stream, refuses capture with that reason
(``aot.CaptureRefused``), and each of its steps is counted as an
uncaptured dispatch.
``fitDataSet(stepsPerSync=k)`` runs the networks' block driver (one host
sync a block of k batches), and ``evaluate`` and ``fit``'s listeners are
the training runtime's.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.ops_impl import (
    CONTROL_OPS, DEVICE_OPS, OPS, STOCHASTIC_OPS, abs_select,
)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ndarray import random as _random
from deeplearning4j_tpu_torch.ndarray.dtype import numpy_name, resolve
from deeplearning4j_tpu_torch.ndarray.ndarray import (
    INDArray, _from_numpy, to_numpy,
)
from deeplearning4j_tpu_torch.nn import updaters as _upd
from deeplearning4j_tpu_torch.nn.conf import dropout as _dropout
from deeplearning4j_tpu_torch.nn import weights as _weights

__all__ = ["SameDiff", "SDVariable", "TrainingConfig", "VariableType"]


def _stream_seed(stream, i, path=()):
    """The seed of op `i`'s generator in `stream` (0: output; it + 1: the
    fit step at iteration `it`). `path` places a control-flow body's op:
    (1_000_000 + the control op's index, ...) for an ``ifCond`` branch,
    (1_000_000 + index, iteration, lane) for a loop's condition (lane 2)
    and body (lane 3), nested bodies appending theirs."""
    for p in path:
        stream = (stream * 0xBF58476D1CE4E5B9 + p * 0x94D049BB133111EB
                  + 0x2545F4914F6CDD1D) % (2 ** 64)
    return (stream * 0x9E3779B97F4A7C15 + i * 0xD1B54A32D192ED03
            + 0x632BE59BD9B4E019) % (2 ** 63)


#: the op kwargs that hold a body's in-memory callable; its recorded
#: spec is the matching ``*Graph`` key
_BODY_CALLABLE_KEYS = ("trueBody", "falseBody", "condBody", "loopBody")


class VariableType:
    """Reference: org.nd4j.autodiff.samediff.VariableType."""

    PLACEHOLDER = "PLACEHOLDER"
    VARIABLE = "VARIABLE"   # trainable
    CONSTANT = "CONSTANT"
    ARRAY = "ARRAY"         # op output


class SDVariable:
    """Symbolic handle into a SameDiff graph (reference: SDVariable).
    Operator overloads route through the op table, so ``a * b + c``
    builds graph nodes exactly like explicit namespace calls."""

    def __init__(self, sd, name, vtype):
        self.sd = sd
        self.name = name
        self.variableType = vtype

    # -- graph-building sugar --
    def _bin(self, opname, other, reverse=False):
        other = self.sd._lift(other)
        a, b = (other, self) if reverse else (self, other)
        return self.sd._op(opname, [a, b])

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, True)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o, True)
    def __truediv__(self, o): return self._bin("div", o)
    def __rtruediv__(self, o): return self._bin("div", o, True)
    def __pow__(self, o): return self._bin("pow", o)
    def __neg__(self): return self.sd._op("neg", [self])
    def __matmul__(self, o): return self._bin("mmul", o)

    def add(self, o): return self._bin("add", o)
    def sub(self, o): return self._bin("sub", o)
    def mul(self, o): return self._bin("mul", o)
    def div(self, o): return self._bin("div", o)
    def rsub(self, o): return self._bin("sub", o, True)
    def rdiv(self, o): return self._bin("div", o, True)
    def mmul(self, o): return self._bin("mmul", o)

    def dot(self, o):
        return self.sd._op("sum", [self._bin("mul", o)])

    def neg(self): return self.sd._op("neg", [self])

    def sum(self, *dimensions, keepDims=False):
        return self.sd._op("sum", [self],
                           {"dimensions": list(dimensions) or None,
                            "keepDims": keepDims})

    def mean(self, *dimensions, keepDims=False):
        return self.sd._op("mean", [self],
                           {"dimensions": list(dimensions) or None,
                            "keepDims": keepDims})

    def std(self, *dimensions):
        return self.sd._op("std", [self],
                           {"dimensions": list(dimensions) or None})

    def norm2(self, *dimensions):
        return self.sd._op("norm2", [self],
                           {"dimensions": list(dimensions) or None})

    def argmax(self, dimension=None):
        return self.sd._op(
            "argmax", [self],
            {"dimensions": None if dimension is None else [dimension]})

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return self.sd._op("reshape", [self], {"shape": list(shape)})

    def permute(self, *dims):
        return self.sd._op("permute", [self], {"dimensions": list(dims)})

    def transpose(self):
        return self.sd._op("transpose", [self])

    def get(self, *idx):
        """Static strided view (reference: SDVariable.get(SDIndex...))."""
        begin, end, strides = [], [], []
        shp = self.shape

        def norm(v, i):
            return v + shp[i] if v < 0 else v

        for i, ix in enumerate(idx):
            if isinstance(ix, slice):
                begin.append(norm(ix.start or 0, i))
                end.append(shp[i] if ix.stop is None else norm(ix.stop, i))
                strides.append(ix.step or 1)
            else:
                p = norm(int(ix), i)
                begin.append(p)
                end.append(p + 1)
                strides.append(1)
        for i in range(len(idx), len(shp)):
            begin.append(0)
            end.append(shp[i])
            strides.append(1)
        out = self.sd._op("stridedSlice", [self],
                          {"begin": begin, "end": end, "strides": strides})
        drop = [i for i, ix in enumerate(idx) if not isinstance(ix, slice)]
        return out if not drop else self.sd._op("squeeze", [out],
                                                {"axis": tuple(drop)})

    def castTo(self, dtype):
        return self.sd._op("cast", [self], {"dtype": numpy_name(dtype)})

    # -- state --
    def rename(self, new):
        self.sd._rename(self.name, new)
        return self

    @property
    def shape(self):
        return self.sd._shape_of(self.name)

    def getArr(self):
        """Current value (a copy, for VARIABLE/CONSTANT) or the eval with
        no placeholders."""
        if self.name in self.sd._arrays:
            return INDArray(self.sd._arrays[self.name].clone())
        return self.eval()

    def setArray(self, arr):
        self.sd._arrays[self.name] = self.sd._own(arr)

    def eval(self, placeholders=None):
        return self.sd.output(placeholders or {}, [self.name])[self.name]

    def markAsLoss(self):
        self.sd.setLossVariables(self.name)
        return self

    def __repr__(self):
        return f"SDVariable(name='{self.name}', type={self.variableType})"


class _Op:
    __slots__ = ("opName", "inputs", "outputs", "kwargs")

    def __init__(self, opName, inputs, outputs, kwargs):
        self.opName = opName
        self.inputs = inputs      # list[str]
        self.outputs = outputs    # list[str]
        self.kwargs = kwargs      # JSON-able dict


class TrainingConfig:
    """Reference: org.nd4j.autodiff.samediff.TrainingConfig (Builder)."""

    def __init__(self, updater=None, dataSetFeatureMapping=None,
                 dataSetLabelMapping=None, l1=0.0, l2=0.0, weightDecay=0.0,
                 lossVariables=None):
        self.updater = updater or _upd.Adam()
        self.dataSetFeatureMapping = dataSetFeatureMapping or []
        self.dataSetLabelMapping = dataSetLabelMapping or []
        self.l1 = l1
        self.l2 = l2
        self.weightDecay = weightDecay
        self.lossVariables = lossVariables

    class Builder:
        def __init__(self):
            self._kw = {}

        def updater(self, u):
            self._kw["updater"] = u
            return self

        def dataSetFeatureMapping(self, *names):
            self._kw["dataSetFeatureMapping"] = list(names)
            return self

        def dataSetLabelMapping(self, *names):
            self._kw["dataSetLabelMapping"] = list(names)
            return self

        def l1(self, v):
            self._kw["l1"] = v
            return self

        def l2(self, v):
            self._kw["l2"] = v
            return self

        def weightDecay(self, v):
            self._kw["weightDecay"] = v
            return self

        def build(self):
            return TrainingConfig(**self._kw)


class SameDiff:
    """The graph container and its executor (reference:
    SameDiff.create()), on one device: the card unless the caller asks
    for the CPU."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._vars = {}        # name -> SDVariable
        self._arrays = {}      # name -> tensor (VARIABLE/CONSTANT)
        self._ops = []         # list[_Op]
        self._producer = {}    # out name -> op index
        self._counter = 0
        self._scopes = []      # the active withNameScope stack
        self._loss_vars = []
        self._tc = None
        self._train_state = None
        self._update_impl = None  # the ZeRO hook (shardWeightUpdate)
        self._pending_updater_leaves = None
        self._iteration = 0
        self._control_syncs = 0   # host fetches made by control flow
        self._sync_owner = self   # a body graph counts on its outer graph
        self._body_cache = {}     # (op id, body, arg shapes) -> sub-graph
        # namespaces (reference: sd.math(), sd.nn(), ...)
        self.math = _MathOps(self)
        self.nn = _NNOps(self)
        self.cnn = _CNNOps(self)
        self.rnn = _RNNOps(self)
        self.loss = _LossOps(self)
        self.image = _ImageOps(self)
        self.linalg = _LinalgOps(self)
        self.bitwise = _BitwiseOps(self)
        self.random = _RandomOps(self)
        self.fft = _FFTOps(self)

    @staticmethod
    def create(device=None):
        return SameDiff(device)

    # ---------- variable creation ----------
    def _own(self, x) -> torch.Tensor:
        """A private copy of `x` on the graph's device."""
        if isinstance(x, INDArray):
            x = x.tensor()
        if isinstance(x, torch.Tensor):
            return x.detach().to(self.device).clone()
        return _from_numpy(x, self.device)

    def _in(self, x) -> torch.Tensor:
        """A fed value (placeholder) as a tensor on the graph's device."""
        if isinstance(x, INDArray):
            x = x.tensor()
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return _from_numpy(x, self.device)

    def _scoped(self, name):
        """Apply the active name-scope prefix ("scope/name")."""
        return "/".join(self._scopes + [name]) if self._scopes else name

    def withNameScope(self, scope):
        """Context manager: variables created inside get "scope/"-prefixed
        names; scopes nest ("outer/inner/x")."""
        sd = self

        class _Scope:
            def __enter__(self_s):
                sd._scopes.append(str(scope))
                return sd

            def __exit__(self_s, *exc):
                sd._scopes.pop()
                return False

        return _Scope()

    def _name(self, base):
        self._counter += 1
        n = f"{base}_{self._counter}"
        while self._scoped(n) in self._vars:
            self._counter += 1
            n = f"{base}_{self._counter}"
        return n

    def _new_var(self, name, vtype):
        name = self._scoped(name)
        if name in self._vars:
            raise ValueError(f"variable '{name}' already exists")
        v = SDVariable(self, name, vtype)
        self._vars[name] = v
        return v

    def placeHolder(self, name, dtype=torch.float32, *shape):
        v = self._new_var(name, VariableType.PLACEHOLDER)
        v._ph_shape = tuple(shape)
        v._ph_dtype = resolve(dtype)
        return v

    def var(self, name, *args, weightInit=None, shape=None,
            dtype=torch.float32):
        """sd.var("w", 4, 5) / sd.var("w", init_array) — trainable."""
        v = self._new_var(name, VariableType.VARIABLE)
        if len(args) == 1 and not isinstance(args[0], (int, np.integer)):
            self._arrays[v.name] = self._own(args[0])
        else:
            shp = tuple(shape) if shape else tuple(int(a) for a in args)
            scheme = weightInit or _weights.WeightInit.XAVIER
            fan_in = shp[0] if shp else 1
            fan_out = shp[-1] if shp else 1
            self._arrays[v.name] = _weights.init(
                _random.getRandom().generator("cpu"), scheme, shp, fan_in,
                fan_out, resolve(dtype), self.device)
        return v

    def constant(self, value, name=None):
        name = name or self._name("const")
        v = self._new_var(name, VariableType.CONSTANT)
        self._arrays[v.name] = self._own(value)
        return v

    def _lift(self, x):
        if isinstance(x, SDVariable):
            return x
        return self.constant(x)

    def _rename(self, old, new):
        if new in self._vars:
            raise ValueError(f"'{new}' already exists")
        v = self._vars.pop(old)
        v.name = new
        self._vars[new] = v
        if old in self._arrays:
            self._arrays[new] = self._arrays.pop(old)
        if old in self._producer:
            self._producer[new] = self._producer.pop(old)
        for op in self._ops:
            op.inputs = [new if n == old else n for n in op.inputs]
            op.outputs = [new if n == old else n for n in op.outputs]
        self._loss_vars = [new if n == old else n for n in self._loss_vars]

    # ---------- op registration ----------
    def _op(self, opName, inputs, kwargs=None, nOut=1, name=None):
        if opName not in OPS:
            raise ValueError(f"unknown op '{opName}'")
        in_names = [v.name for v in inputs]
        outs = []
        for _ in range(nOut):
            base = name if name else opName
            n = base if (name and nOut == 1
                         and self._scoped(name) not in self._vars) \
                else self._name(base)
            # the op table stores the SCOPED name _new_var registers
            outs.append(self._new_var(n, VariableType.ARRAY).name)
        self._ops.append(_Op(opName, in_names, outs, kwargs or {}))
        idx = len(self._ops) - 1
        for n in outs:
            self._producer[n] = idx
        out_vars = [self._vars[n] for n in outs]
        return out_vars[0] if nOut == 1 else tuple(out_vars)

    def getVariable(self, name):
        return self._vars[name]

    def variables(self):
        return [v for v in self._vars.values()
                if v.variableType == VariableType.VARIABLE]

    def setLossVariables(self, *names):
        self._loss_vars = [n.name if isinstance(n, SDVariable) else n
                           for n in names]

    # ---------- control flow (reference: the If / While ops) ----------
    def ifCond(self, pred, trueBody, falseBody, inputs=(), nOut=1,
               name=None):
        """Conditional subgraph (reference: SameDiff.ifCond). `pred` is a
        scalar; each body is ``lambda sd, *vars: SDVariable`` (or a tuple
        of them) built on a sub-SameDiff whose placeholders mirror
        `inputs`. The predicate is read on the host and one branch runs;
        autograd flows through it."""
        ins = [self._lift(pred)] + [self._lift(v) for v in inputs]
        n = len(ins) - 1
        return self._op("if_cond", ins,
                        kwargs={"trueBody": trueBody, "falseBody": falseBody,
                                "trueGraph": _record_body(
                                    trueBody, n, "ifCond trueBody"),
                                "falseGraph": _record_body(
                                    falseBody, n, "ifCond falseBody")},
                        nOut=nOut, name=name)

    def whileLoop(self, condBody, loopBody, loopVars, maxIterations=None,
                  name=None):
        """While loop over subgraphs (reference: SameDiff.whileLoop).
        condBody(sd, *vars) -> scalar; loopBody(sd, *vars) -> the updated
        vars. ``maxIterations=None``: a true data-dependent trip count,
        one host fetch of the predicate an iteration, inference-only.
        ``maxIterations=N``: N masked iterations, ``where(pred, new,
        old)`` each, no host sync, differentiable."""
        ins = [self._lift(v) for v in loopVars]
        return self._op("while_loop", ins,
                        kwargs={"condBody": condBody, "loopBody": loopBody,
                                "condGraph": _record_body(
                                    condBody, len(ins), "whileLoop condBody"),
                                "loopGraph": _record_body(
                                    loopBody, len(ins), "whileLoop loopBody"),
                                "maxIterations": (None if maxIterations is None
                                                  else int(maxIterations))},
                        nOut=len(ins), name=name)

    cond = ifCond
    while_loop = whileLoop

    def _body_graph(self, op, key, args, n_expected, what):
        """The sub-SameDiff of one of `op`'s bodies over placeholders
        shaped like `args`, and its output names. Built once per arg
        signature (the reference rebuilds it at every trace): a body's
        constants reach the device once."""
        sig = (id(op), key, tuple((tuple(a.shape), a.dtype) for a in args))
        hit = self._body_cache.get(sig)
        if hit is not None:
            return hit
        build = op.kwargs.get(key) or _body_from_spec(
            op.kwargs[key.replace("Body", "Graph")])
        sub = SameDiff(self.device)
        sub._sync_owner = self._sync_owner
        phs = [sub.placeHolder(f"in{i}", a.dtype, *a.shape)
               for i, a in enumerate(args)]
        out = build(sub, *phs)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        if n_expected is not None and len(outs) != n_expected:
            raise ValueError(
                f"{what} returned {len(outs)} output(s) but {n_expected} "
                f"were declared (nOut / len(loopVars))")
        hit = (sub, [p.name for p in phs], [o.name for o in outs])
        self._body_cache[sig] = hit
        return hit

    @staticmethod
    def _run_body(body, args, train, stream, path):
        sub, ins, outs = body
        env = sub._base_env()
        if args and args[0].device.type == "meta":     # shape inference
            env = {n: torch.empty(a.shape, dtype=a.dtype, device="meta")
                   for n, a in env.items()}
        env.update(zip(ins, args))
        res = sub._run_graph(env, outs, train=train, stream=stream,
                             path=path)
        return [res[n] for n in outs]

    def _host_pred(self, p):
        """A predicate read on the host: one sync, counted on the
        outermost graph (under a capture's warm-up, a refusal)."""
        sites = _dropout._SITES.get()
        if sites is not None:
            sites.refuse("ifCond or an unbounded whileLoop reads its "
                         "predicate on the host (_control_syncs)")
        self._sync_owner._control_syncs += 1
        return bool(p.reshape(()).to(torch.bool))

    def _exec_if_cond(self, op, env, train, stream, path, i):
        pred, *args = [env[n] for n in op.inputs]
        no = len(op.outputs)
        # the branches have one signature (lax.cond's rule), so shape
        # inference over meta tensors runs the true one
        take = pred.device.type == "meta" or self._host_pred(pred)
        key = "trueBody" if take else "falseBody"
        body = self._body_graph(op, key, args, no, f"ifCond {key}")
        return self._run_body(body, args, train, stream,
                              path + (1_000_000 + i,))

    def _exec_while_loop(self, op, env, train, stream, path, i):
        vs = [env[n] for n in op.inputs]
        if vs and vs[0].device.type == "meta":
            return vs                    # the carry keeps its shapes
        cond = self._body_graph(op, "condBody", vs, None,
                                "whileLoop condBody")
        body = self._body_graph(op, "loopBody", vs, len(op.outputs),
                                "whileLoop loopBody")
        max_it = op.kwargs.get("maxIterations")
        base = path + (1_000_000 + i,)
        if max_it is None:
            if torch.is_grad_enabled() and any(v.requires_grad for v in vs):
                raise ValueError(
                    "Reverse-mode differentiation does not work for an "
                    "unbounded whileLoop (maxIterations=None); pass "
                    "maxIterations for a differentiable masked loop")
            t = 0
            while self._host_pred(self._run_body(
                    cond, vs, train, stream, base + (t, 2))[0]):
                vs = self._run_body(body, vs, train, stream, base + (t, 3))
                t += 1
            return vs
        for t in range(int(max_it)):
            p = self._run_body(cond, vs, train, stream,
                               base + (t, 2))[0].reshape(()).to(torch.bool)
            new = self._run_body(body, vs, train, stream, base + (t, 3))
            vs = [torch.where(p, n, v) for n, v in zip(new, vs)]
        return vs

    # ---------- execution ----------
    def _slice_for(self, out_names):
        """Backward slice: op indices needed to compute out_names, in
        order."""
        needed = set()
        stack = list(out_names)
        seen = set()
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            if n in self._producer:
                i = self._producer[n]
                needed.add(i)
                stack.extend(self._ops[i].inputs)
        return sorted(needed)

    def _gen(self, stream, i, path=()):
        sites = _dropout._SITES.get()
        if sites is not None:
            sites.refuse(f"op {i} draws from the step's host-seeded "
                         "stream, which a graph would bake in")
        g = torch.Generator(device=self.device)
        g.manual_seed(_stream_seed(stream, i, path))
        return g

    def _run_graph(self, env, out_names, train=False, stream=None,
                   path=()):
        """Interpret the slice for `out_names` over the tensors in `env`.
        `train`/`stream` thread training mode and the step's random
        stream into the stochastic ops (None: output()'s fixed stream,
        and dropout is the identity); `path` places a body's ops."""
        for i in self._slice_for(out_names):
            op = self._ops[i]
            if op.opName in CONTROL_OPS:
                run = self._exec_if_cond if op.opName == "if_cond" \
                    else self._exec_while_loop
                res = run(op, env, train, stream, path, i)
                env.update(zip(op.outputs, res))
                continue
            args = [env[n] for n in op.inputs]
            kwargs = op.kwargs
            if op.opName == "dropout":
                on = train and stream is not None
                kwargs = dict(kwargs, train=on,
                              gen=self._gen(stream, i, path) if on else None)
            elif op.opName in STOCHASTIC_OPS:
                kwargs = dict(kwargs, gen=self._gen(
                    0 if stream is None else stream, i, path))
            elif op.opName in DEVICE_OPS:
                kwargs = dict(kwargs, device=self.device)
            res = OPS[op.opName](*args, **kwargs)
            if len(op.outputs) == 1:
                env[op.outputs[0]] = res
            else:
                for n, r in zip(op.outputs, res):
                    env[n] = r
        return {n: env[n] for n in out_names}

    def _base_env(self):
        return dict(self._arrays)

    def precompile(self, features=None, labels=None, data=None,
                   cache=None):
        """Capture the training step at one batch signature (reference:
        ``precompile``): pass one example batch, (features, labels) or a
        DataSet. On the card a CUDA graph that the fits replay; on the
        CPU the same warm-up, eagerly, with its key. The variables,
        updater state and iteration are as before. Returns {"fit_step":
        {key, status, seconds}}; raises ``aot.CaptureRefused`` for a
        graph that cannot be captured (module docstring)."""
        from deeplearning4j_tpu_torch.runtime import aot

        if self._tc is None:
            raise ValueError("setTrainingConfig first")
        cap = self._fit_capture()
        if cache is not None:
            cap.pin_cache(cache)
        if cap.refusal is not None:
            cap.cache().note_uncaptured(cap.entry, "refused")
            raise aot.CaptureRefused(cap.refusal)
        phs = self._batch_to_placeholders(
            data if data is not None else (features, labels), self._tc)
        key, status, secs = cap.capture((phs,), iteration=self._iteration)
        return {"fit_step": {"key": key, "status": status,
                             "seconds": round(secs, 3)}}

    def _fit_capture(self):
        """The ``CapturedStep`` of the training step (made once a
        TrainingConfig and variable set)."""
        from deeplearning4j_tpu_torch.runtime import aot

        sig = (id(self._tc), tuple(self._trainables()), len(self._ops))
        if getattr(self, "_captured_sig", None) != sig:
            sd = self

            def body(phs, iteration):
                tc, loss_names, params, state = sd._fit_setup()
                loss, _ = sd._step(tc, loss_names, params, state, phs,
                                   iteration, hyper=sd._hyper_scalars())
                return loss

            def snapshot():
                with torch.no_grad():
                    return [t.detach().clone() for t in sd._step_tensors()]

            def restore(snap):
                with torch.no_grad():
                    for t, v in zip(sd._step_tensors(), snap):
                        t.copy_(v)

            self._hyper = None
            self._captured = aot.CapturedStep(
                body, entry="fit_step",
                fingerprint=aot.samediff_fingerprint(self),
                prologue=lambda iteration: self._hyper_scalars().write(
                    iteration),
                snapshot=snapshot, restore=restore)
            self._captured_sig = sig
        return self._captured

    def _hyper_scalars(self):
        if getattr(self, "_hyper", None) is None:
            params = [self._arrays[n] for n in self._trainables()]
            dt = torch.float64 if any(p.dtype == torch.float64
                                      for p in params) else torch.float32
            self._hyper = _upd.HyperScalars([self._tc.updater], dt,
                                            self.device)
        return self._hyper

    def _step_tensors(self):
        """The tensors a training step writes in place: the variables
        and the updater state."""
        from deeplearning4j_tpu_torch.nn.multilayer import tree_leaves

        tc, _, params, state = self._fit_setup()
        return [params[n] for n in sorted(params)] + [
            t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]

    def _dispatch_step(self, tc, loss_names, params, state, phs, it):
        """One training step: a replay of the captured graph at this
        batch's signature once ``precompile`` ran (an uncaptured one is
        counted), else the eager step. Returns (loss, state)."""
        cap = getattr(self, "_captured", None)
        if cap is None or getattr(self, "_captured_sig", None) != (
                id(tc), tuple(self._trainables()), len(self._ops)):
            return self._step(tc, loss_names, params, state, phs, it)
        if cap.refusal is not None:
            return cap._eager((phs,), {"iteration": it}, "refused"), state
        return cap(phs, iteration=it).clone(), state

    def output(self, placeholders, outputs):
        """Run the slice for `outputs` (reference: SameDiff.output/exec)
        -> {name: INDArray}."""
        out_names = [o.name if isinstance(o, SDVariable) else o
                     for o in outputs]
        env = self._base_env()
        env.update({k: self._in(v) for k, v in (placeholders or {}).items()})
        stored = {id(t) for t in self._arrays.values()}
        with torch.no_grad():
            res = self._run_graph(env, out_names)
        return {k: INDArray(v.clone() if id(v) in stored else v)
                for k, v in res.items()}

    def exec(self, placeholders, *outputs):
        return self.output(placeholders, list(outputs))

    def batchOutput(self):
        sd = self

        class _B:
            def __init__(b):
                b._ph, b._out = {}, []

            def input(b, name, arr):
                b._ph[name] = arr
                return b

            def output(b, *names):
                b._out.extend(n.name if isinstance(n, SDVariable) else n
                              for n in names)
                return b

            def out(b, *names):
                return b.output(*names)

            def exec(b):
                return sd.output(b._ph, b._out)

        return _B()

    def _shape_of(self, name):
        if name in self._arrays:
            return tuple(self._arrays[name].shape)
        v = self._vars[name]
        if v.variableType == VariableType.PLACEHOLDER:
            return v._ph_shape
        return self._eval_shapes([name])[name]

    def _eval_shapes(self, names):
        """Shapes of `names` from a run over meta tensors (no data)."""
        env = {n: torch.empty(a.shape, dtype=a.dtype, device="meta")
               for n, a in self._arrays.items()}
        env.update({n: torch.empty(v._ph_shape, dtype=v._ph_dtype,
                                   device="meta")
                    for n, v in self._vars.items()
                    if v.variableType == VariableType.PLACEHOLDER})
        with torch.no_grad():
            out = self._run_graph(env, names)
        return {n: tuple(t.shape) for n, t in out.items()}

    # ---------- autodiff ----------
    def _loss_names(self):
        if self._loss_vars:
            return self._loss_vars
        if self._tc and self._tc.lossVariables:
            return self._tc.lossVariables
        raise ValueError("no loss variables set; call setLossVariables()")

    def calculateGradients(self, placeholders, *wrt):
        """d(sum of the loss variables' sums)/d(wrt) (reference:
        SameDiff.calculateGradients) -> {name: INDArray}. `wrt` may name
        variables, constants or fed placeholders."""
        wrt_names = [w.name if isinstance(w, SDVariable) else w for w in wrt]
        loss_names = self._loss_names()
        ph = {k: self._in(v) for k, v in (placeholders or {}).items()}
        w_names = [n for n in wrt_names if n in self._arrays]
        p_names = [n for n in wrt_names if n not in self._arrays]
        missing = [n for n in p_names if n not in ph]
        if missing:
            raise ValueError(f"wrt {missing} are placeholders but no value "
                             f"was provided in `placeholders`")
        env = self._base_env()
        env.update(ph)
        leaves = {n: env[n].detach().requires_grad_(True)
                  for n in w_names + p_names}
        if not leaves:      # nothing to differentiate: as the reference
            return {}
        env.update(leaves)
        with torch.enable_grad():
            outs = self._run_graph(env, loss_names)
            loss = sum(torch.sum(o) for o in outs.values())
            gs = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
        return {n: INDArray(torch.zeros_like(t) if g is None else g)
                for (n, t), g in zip(leaves.items(), gs)}

    def grad(self, name):
        """Gradient accessor: evaluates through calculateGradients."""
        return _GradAccessor(self, name)

    # ---------- training ----------
    def setTrainingConfig(self, tc):
        self._tc = tc
        self._train_state = None

    def _trainables(self):
        return sorted(n for n, v in self._vars.items()
                      if v.variableType == VariableType.VARIABLE)

    def _train_state_for(self, params, updater):
        z = self._update_impl
        if self._train_state is None and z is not None \
                and self._pending_updater_leaves is None:
            self._train_state = z.init_state(updater, params)
        if self._train_state is None:
            with torch.no_grad():
                state = updater.init(params)
            if self._pending_updater_leaves is not None:
                # a file's state: its leaves in jax.tree_util order, put
                # into the structure (and dtypes) the updater gives
                from deeplearning4j_tpu_torch.util.sharded_checkpoint \
                    import _fill
                from deeplearning4j_tpu_torch.nn.multilayer import \
                    tree_leaves

                like = tree_leaves(state)
                leaves = self._pending_updater_leaves
                if len(leaves) != len(like):
                    raise ValueError(
                        f"updater.npz holds {len(leaves)} leaves; the "
                        f"TrainingConfig's updater has {len(like)}")
                state = _fill(state, [
                    _from_numpy(a, self.device).to(t.dtype).reshape(t.shape)
                    for a, t in zip(leaves, like)])
                self._pending_updater_leaves = None
            self._train_state = state if z is None else z.place_state(state)
        return self._train_state

    def _step(self, tc, loss_names, params, state, phs, it, hyper=None):
        """One training step at iteration `it`: forward, loss, gradients,
        weight decay and the update, which writes the graph's variable
        tensors in place (`hyper`: the updater's hyperparameters as
        device scalars, as a captured step reads them). Returns the loss
        tensor (not fetched)."""
        from deeplearning4j_tpu_torch.nn.multilayer import \
            default_param_update

        env = self._base_env()
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        env.update(leaves)
        env.update(phs)
        with torch.enable_grad():
            outs = self._run_graph(env, loss_names, train=True,
                                   stream=it + 1)
            # a marked loss may be per-example in a sub-fp32 graph: its
            # sum accumulates in fp32 so the training loss is fp32
            loss = sum(torch.sum(o, dtype=torch.promote_types(
                o.dtype, torch.float32)) for o in outs.values())
            if tc.l2:
                loss = loss + tc.l2 * sum(torch.sum(torch.square(a))
                                          for a in leaves.values())
            if tc.l1:
                # |a| with the reference's gradient at 0 (+1): a bias
                # that starts at zero takes its l1 pull on step one
                loss = loss + tc.l1 * sum(torch.sum(abs_select(a))
                                          for a in leaves.values())
            gs = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True) if leaves else ()
        with torch.no_grad():
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(params.items(), gs)}
            if tc.weightDecay:
                grads = {n: g + tc.weightDecay * params[n]
                         for n, g in grads.items()}
            hp = None if hyper is None else hyper.views(0)
            if self._update_impl is not None:
                state = self._update_impl.step(
                    [(tc.updater, grads, state, params, hp)], it)[0]
            else:
                _, state = default_param_update(tc.updater, grads, state,
                                                it, params, hp)
        return loss.detach(), state

    def _fit_setup(self):
        if self._tc is None:
            raise ValueError("setTrainingConfig first")
        tc = self._tc
        params = {n: self._arrays[n] for n in self._trainables()}
        return tc, self._loss_names(), params, \
            self._train_state_for(params, tc.updater)

    def fit(self, data=None, epochs=1, features=None, labels=None,
            listeners=None):
        """Train with the TrainingConfig (reference: SameDiff.fit): one
        step per batch; ``data`` is a DataSet, a (features, labels) pair
        or a list of them. Each listener's ``iterationDone(sd, iteration,
        loss)`` fires after every step. Returns the loss of every step."""
        tc, loss_names, params, state = self._fit_setup()
        if data is not None and features is None:
            batches = data if isinstance(data, (list, tuple)) else [data]
        else:
            batches = [(features, labels)]
        history = []
        for _ in range(epochs):
            for b in batches:
                phs = self._batch_to_placeholders(b, tc)
                loss, state = self._dispatch_step(tc, loss_names, params,
                                                  state, phs,
                                                  self._iteration)
                self._train_state = state
                self._iteration += 1
                history.append(float(loss))
                for lst in (listeners or []):
                    lst.iterationDone(self, self._iteration, history[-1])
        return history

    def fitSteps(self, features=None, labels=None, numSteps=1, data=None):
        """numSteps optimizer steps on one batch, with one loss fetch at
        the end; the same steps, streams and iteration counter as
        numSteps fit() calls. Returns the last loss."""
        tc, loss_names, params, state = self._fit_setup()
        phs = self._batch_to_placeholders(
            data if data is not None else (features, labels), tc)
        loss = None
        for _ in range(int(numSteps)):
            loss, state = self._dispatch_step(tc, loss_names, params, state,
                                              phs, self._iteration)
            self._train_state = state
            self._iteration += 1
        return float(loss)

    def fitDataSet(self, iterator, stepsPerSync=1, epochs=1,
                   listeners=None):
        """Epoch training with one host sync a block of ``stepsPerSync``
        fresh batches (reference: SameDiff.fitDataSet), through the
        networks' block driver (``nn.multilayer.run_staged_blocks``): k
        batches are staged on the device as one copy, their k steps are
        issued back to back with the iteration and streams ``fit`` gives
        them, and the k losses are read one block behind. The ragged
        final stack runs through ``fit``. Returns the loss history (one
        float a step); the host syncs are left in
        ``_fit_dataset_syncs``, control flow's predicate fetches
        included."""
        from deeplearning4j_tpu_torch.data.iterators import iter_stacks
        from deeplearning4j_tpu_torch.nn.multilayer import (
            BlockStager, check_steps_per_sync, launch_block,
            run_staged_blocks, wait_block,
        )

        if self._tc is None:
            raise ValueError("setTrainingConfig first")
        k = check_steps_per_sync(stepsPerSync)
        if epochs > 1 and not hasattr(iterator, "reset"):
            raise ValueError(
                f"fitDataSet(epochs={epochs}) needs a resettable "
                "iterator (with reset()/hasNext()/next()); a plain "
                "iterable can only run one epoch")
        control0 = self._control_syncs
        if k == 1:
            history = []
            for _ in range(epochs):
                if hasattr(iterator, "reset"):
                    iterator.reset()
                for stack in iter_stacks(iterator, 1):
                    history.extend(self.fit(data=stack[0],
                                            listeners=listeners))
            # one per batch, plus control flow's
            self._fit_dataset_syncs = len(history) + \
                self._control_syncs - control0
            return history
        tc, loss_names, params, _ = self._fit_setup()
        stager = BlockStager(self.device)
        history = []
        self._fit_dataset_syncs = 0
        it_next = 0   # the dispatch-side iteration cursor

        def step(tensors, it):
            loss, self._train_state = self._dispatch_step(
                tc, loss_names, params, self._train_state,
                self._batch_args(tensors), it)
            return loss

        def dispatch(batches):
            nonlocal it_next
            staged, ready = stager(self, batches)
            host, event = launch_block(self, staged, ready, it_next, step)
            it_next += k
            return host, event

        def consume(pending):
            host, event = pending
            self._fit_dataset_syncs += 1
            wait_block(event)   # THE host sync of this block
            vals = host.numpy()
            for v in vals:
                self._iteration += 1
                history.append(float(v))
                for lst in (listeners or []):
                    lst.iterationDone(self, self._iteration, float(v))
            for lst in (listeners or []):
                fn = getattr(lst, "onSyncBoundary", None)
                if fn is not None:
                    fn(self, self._iteration, vals)

        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            it_next = self._iteration
            tail = run_staged_blocks(iterator, k, dispatch, consume)
            for b in tail:
                history.extend(self.fit(data=b, listeners=listeners))
                self._fit_dataset_syncs += 1
        self._fit_dataset_syncs += self._control_syncs - control0
        return history

    def _batch_arrays(self, b):
        """A batch as numpy arrays: the features, then the labels, in the
        TrainingConfig's mapping order (None for an absent label)."""
        from deeplearning4j_tpu_torch.data.dataset import _np

        feats, labs = self._batch_lists(b, self._tc)
        labs = list(labs) + [None] * (len(self._tc.dataSetLabelMapping)
                                      - len(labs))
        return [_np(a) for a in feats + labs]

    def _batch_array_names(self, n):
        tc = self._tc
        return list(tc.dataSetFeatureMapping) + list(tc.dataSetLabelMapping)

    def _batch_args(self, tensors):
        tc = self._tc
        names = list(tc.dataSetFeatureMapping) + list(tc.dataSetLabelMapping)
        return {n: t for n, t in zip(names, tensors) if t is not None}

    def evaluate(self, iterator, outputVariable, *evaluations):
        """Stream a DataSetIterator through the graph into any number of
        IEvaluation instances (reference: SameDiff.evaluate): features
        bind through the TrainingConfig's dataSetFeatureMapping, labels go
        to the evaluations. Returns the evaluation, or a tuple of them."""
        if self._tc is None:
            raise ValueError("setTrainingConfig first (evaluate needs the "
                             "dataSetFeatureMapping to bind features)")
        if not evaluations:
            from deeplearning4j_tpu_torch.evaluation.evaluation import \
                Evaluation

            evaluations = (Evaluation(),)
        out_name = getattr(outputVariable, "name", outputVariable)
        iterator.reset()
        while iterator.hasNext():
            ds = iterator.next()
            feats, _ = self._batch_lists(ds, self._tc, bind_labels=False)
            phs = {n: self._in(a)
                   for n, a in zip(self._tc.dataSetFeatureMapping, feats)}
            pred = self.output(phs, [out_name])[out_name]
            mask = ds.getLabelsMaskArray() \
                if hasattr(ds, "getLabelsMaskArray") else None
            for e in evaluations:
                e.eval(ds.getLabels(), pred, mask=mask)
        return evaluations[0] if len(evaluations) == 1 else evaluations

    def shardWeightUpdate(self, mesh=None, batch_axis=None,
                          min_shard_size=2 ** 16):
        """The ZeRO-style sharded weight update for this graph's training
        (reference: ``shardWeightUpdate``;
        ``parallel.sharding.ZeroShardedUpdate``): every rank of `mesh`
        (default: the data axis over every rank) runs the step on its
        batch, the eligible gradients are reduce-scattered into 1/dp
        blocks, the updater runs on this rank's blocks of the variables
        and of its state (allocated sharded) and the fresh blocks are
        all-gathered. An existing updater state is re-placed sharded,
        bitwise; ``save`` writes it canonical. Returns self."""
        from deeplearning4j_tpu_torch.parallel import mesh as _pmesh
        from deeplearning4j_tpu_torch.parallel.sharding import \
            ZeroShardedUpdate

        mesh = mesh if mesh is not None else _pmesh.data_parallel_mesh()
        z = ZeroShardedUpdate(mesh, axis=batch_axis or _pmesh.DATA_AXIS,
                              min_shard_size=min_shard_size)
        if self._train_state is not None:
            if self._update_impl is not None:
                self._train_state = self._canonical_train_state()
            self._train_state = z.place_state(self._train_state)
        self._update_impl = z
        return self

    def _canonical_train_state(self):
        """The updater state in its full-shape layout (a ZeRO hook's
        blocks all-gathered: every rank calls it)."""
        z, st = self._update_impl, self._train_state
        if z is None or st is None:
            return st
        params = {n: self._arrays[n] for n in self._trainables()}
        return z.unview_state(st, self._tc.updater, params)

    def _batch_to_placeholders(self, b, tc):
        feats, labs = self._batch_lists(b, tc)
        phs = {name: self._in(arr)
               for name, arr in zip(tc.dataSetFeatureMapping, feats)}
        for name, arr in zip(tc.dataSetLabelMapping, labs):
            if arr is not None:
                phs[name] = self._in(arr)
        return phs

    @staticmethod
    def _batch_lists(b, tc, bind_labels=True):
        """(feature arrays, label arrays) of a batch, checked against the
        TrainingConfig's mappings."""
        if isinstance(b, (tuple, list)):
            feats = [b[0]] if not isinstance(b[0], (tuple, list)) \
                else list(b[0])
            labs = [b[1]] if not isinstance(b[1], (tuple, list)) \
                else list(b[1])
        elif hasattr(b, "getFeatures"):
            feats = b.getFeatures()
            feats = list(feats) if isinstance(feats, (list, tuple)) \
                else [feats]
            labs = b.getLabels()
            labs = list(labs) if isinstance(labs, (list, tuple)) else [labs]
        else:
            raise TypeError(f"cannot map batch of type {type(b)}")
        # loud on count mismatches: zip would silently truncate
        if len(feats) != len(tc.dataSetFeatureMapping):
            raise ValueError(
                f"batch has {len(feats)} feature array(s) but "
                f"dataSetFeatureMapping names "
                f"{len(tc.dataSetFeatureMapping)}; for a single feature "
                "array the mapping must have exactly one name")
        if bind_labels and labs[0] is not None and \
                tc.dataSetLabelMapping and \
                len(labs) != len(tc.dataSetLabelMapping):
            raise ValueError(
                f"batch has {len(labs)} label array(s) but "
                f"dataSetLabelMapping names {len(tc.dataSetLabelMapping)}")
        return feats, labs

    # ---------- serialization ----------
    def save(self, path, saveUpdaterState=False):
        """graph.json + arrays.npz (+ updater.npz) in one zip: the
        reference's format. Recorded bodies go into graph.json, their
        constants into arrays.npz; a body that could not be recorded
        makes this raise."""
        from deeplearning4j_tpu_torch.nn.multilayer import tree_leaves

        body_store = {}
        op_kwargs = [_clean_spec_kwargs(o.kwargs, f"op{i}", body_store)
                     for i, o in enumerate(self._ops)]
        graph = {
            "variables": [
                {"name": n, "type": v.variableType,
                 "phShape": list(getattr(v, "_ph_shape", ()) or ()),
                 "phDtype": (numpy_name(v._ph_dtype)
                             if hasattr(v, "_ph_dtype") else "")}
                for n, v in self._vars.items()],
            "ops": [{"op": o.opName, "inputs": o.inputs,
                     "outputs": o.outputs, "kwargs": kw}
                    for o, kw in zip(self._ops, op_kwargs)],
            "lossVariables": self._loss_vars,
            "iteration": self._iteration,
        }
        buf = io.BytesIO()
        np.savez(buf, **{n: to_numpy(a) for n, a in self._arrays.items()},
                 **body_store)
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("graph.json", json.dumps(graph))
            z.writestr("arrays.npz", buf.getvalue())
            if saveUpdaterState and self._train_state is not None:
                sbuf = io.BytesIO()
                np.savez(sbuf, *[to_numpy(t) for t in tree_leaves(
                    self._canonical_train_state())])
                z.writestr("updater.npz", sbuf.getvalue())

    @staticmethod
    def load(path, loadUpdaterState=False, device=None):
        """A graph from a ``save`` zip of either package, on `device`.
        With ``loadUpdaterState`` the file's updater state (if it has
        one) is restored at the first ``fit``, into the structure its
        TrainingConfig's updater gives."""
        sd = SameDiff(device)
        with zipfile.ZipFile(path) as z:
            graph = json.loads(z.read("graph.json"))
            npz = np.load(io.BytesIO(z.read("arrays.npz")))
            arrays = {n: _from_numpy(npz[n], sd.device) for n in npz.files
                      if not n.startswith("__body__/")}
            if loadUpdaterState and "updater.npz" in z.namelist():
                snpz = np.load(io.BytesIO(z.read("updater.npz")))
                sd._pending_updater_leaves = [snpz[k] for k in snpz.files]
            for od in graph["ops"]:
                if od["op"] not in OPS:
                    raise ValueError(f"unknown op '{od['op']}'")
                _resolve_spec_kwargs(od["kwargs"], npz)
        for vd in graph["variables"]:
            v = SDVariable(sd, vd["name"], vd["type"])
            if vd["type"] == VariableType.PLACEHOLDER:
                v._ph_shape = tuple(vd["phShape"])
                v._ph_dtype = resolve(vd["phDtype"])
            sd._vars[vd["name"]] = v
        for i, od in enumerate(graph["ops"]):
            sd._ops.append(_Op(od["op"], od["inputs"], od["outputs"],
                               od["kwargs"]))
            for n in od["outputs"]:
                sd._producer[n] = i
        sd._arrays = arrays
        sd._loss_vars = graph.get("lossVariables", [])
        sd._iteration = graph.get("iteration", 0)
        return sd

    def summary(self):
        lines = [f"--- SameDiff: {len(self._vars)} variables, "
                 f"{len(self._ops)} ops ---"]
        for n, v in self._vars.items():
            if v.variableType != VariableType.ARRAY:
                shp = tuple(self._arrays[n].shape) if n in self._arrays \
                    else getattr(v, "_ph_shape", "?")
                lines.append(f"  {v.variableType:<12} {n:<24} {shp}")
        for o in self._ops:
            lines.append(f"  {o.opName}({', '.join(o.inputs)}) -> "
                         f"{', '.join(o.outputs)}")
        return "\n".join(lines)



# ---------------- recorded control-flow bodies ----------------
def _record_body(build_fn, n_inputs, what=""):
    """A control-flow body as a serializable spec (reference:
    ``SameDiff._record_body``): the builder runs once at definition on a
    CPU sub-graph over shapeless placeholders ``in0..``, the names the
    executor's sub-graphs use, so a replay is exact. A body that cannot
    be recorded is marked, and ``save`` refuses the graph."""
    sub = SameDiff("cpu")
    phs = [sub.placeHolder(f"in{i}") for i in range(n_inputs)]
    try:
        out = build_fn(sub, *phs)
    except Exception as e:   # save() raises the clear error instead
        return {"unrecordable": f"{what}: {type(e).__name__}: {e}"}
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return {
        "inputs": [p.name for p in phs],
        "outputs": [o.name for o in outs],
        "variables": [{"name": n, "type": v.variableType}
                      for n, v in sub._vars.items()],
        "ops": [{"op": o.opName, "inputs": o.inputs, "outputs": o.outputs,
                 "kwargs": {k: v for k, v in o.kwargs.items()
                            if k not in _BODY_CALLABLE_KEYS}}
                for o in sub._ops],
        "arrays": dict(sub._arrays),
    }


def _body_from_spec(spec):
    """The inverse of ``_record_body``: a builder that replays the
    recorded ops into the executor's sub-graph."""
    def build(sub, *phs):
        for vd in spec["variables"]:
            if vd["name"] not in sub._vars:
                sub._vars[vd["name"]] = SDVariable(sub, vd["name"],
                                                   vd["type"])
        for n, a in spec["arrays"].items():
            sub._arrays[n] = sub._own(a)
        for od in spec["ops"]:
            sub._ops.append(_Op(od["op"], list(od["inputs"]),
                                list(od["outputs"]), od["kwargs"]))
            for n in od["outputs"]:
                sub._producer[n] = len(sub._ops) - 1
        outs = [sub._vars[n] for n in spec["outputs"]]
        return outs[0] if len(outs) == 1 else tuple(outs)

    return build


def _clean_spec_kwargs(kwargs, path, body_store):
    """Op kwargs for graph.json: the body callables dropped, every
    (nested) recorded body checked, its constants moved to `body_store`
    under ``__body__/<path>/<key>/<name>`` (JSON keeps the npz key)."""
    out = {}
    for k, v in kwargs.items():
        if k in _BODY_CALLABLE_KEYS:
            continue
        if k.endswith("Graph") and isinstance(v, dict):
            if "unrecordable" in v:
                raise NotImplementedError(
                    "Graph cannot be serialized: a control-flow body "
                    "could not be recorded as a subgraph "
                    f"({v['unrecordable']}). Bodies must be pure "
                    "graph-builders over their SDVariable arguments.")
            spec = dict(v)
            refs = {}
            for n, a in spec["arrays"].items():
                key = f"__body__/{path}/{k}/{n}"
                body_store[key] = _host_array(a)
                refs[n] = key
            spec["arrays"] = refs
            spec["ops"] = [
                {"op": o["op"], "inputs": o["inputs"],
                 "outputs": o["outputs"],
                 "kwargs": _clean_spec_kwargs(o["kwargs"], f"{path}/{k}/{j}",
                                              body_store)}
                for j, o in enumerate(spec["ops"])]
            out[k] = spec
        else:
            out[k] = v
    return out


def _resolve_spec_kwargs(kwargs, npz):
    """The inverse of ``_clean_spec_kwargs`` at load: npz keys back to
    arrays, recursively, in place."""
    for k, v in kwargs.items():
        if k.endswith("Graph") and isinstance(v, dict) and "arrays" in v:
            v["arrays"] = {n: npz[ref] for n, ref in v["arrays"].items()}
            for o in v["ops"]:
                _resolve_spec_kwargs(o["kwargs"], npz)


def _host_array(a):
    return to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


class _GradAccessor:
    def __init__(self, sd, name):
        self.sd = sd
        self.name = name.name if isinstance(name, SDVariable) else name

    def eval(self, placeholders=None):
        return self.sd.calculateGradients(placeholders or {},
                                          self.name)[self.name]


# ---------------- op namespaces ----------------
class _NS:
    def __init__(self, sd):
        self.sd = sd

    def _mk(self, opName, inputs, kwargs=None, nOut=1, name=None):
        ins = [self.sd._lift(i) for i in inputs]
        return self.sd._op(opName, ins, kwargs, nOut=nOut, name=name)


class _CNNOps(_NS):
    """Reference: ops.SDCNN. NHWC activations, HWIO kernels (NDHWC and
    DHWIO for conv3d, NWC and WIO for conv1d)."""

    @staticmethod
    def _geom(stride, padding, dilation=None):
        kw = {"stride": list(stride) if isinstance(stride, (tuple, list))
              else stride,
              "padding": [list(p) for p in padding]}
        if dilation is not None:
            kw["dilation"] = list(dilation) \
                if isinstance(dilation, (tuple, list)) else dilation
        return kw

    def conv2d(self, x, w, b=None, stride=(1, 1), padding=((0, 0), (0, 0)),
               dilation=(1, 1), name=None):
        ins = [x, w] + ([b] if b is not None else [])
        return self._mk("conv2d", ins, self._geom(stride, padding, dilation),
                        name=name)

    def conv1d(self, x, w, b=None, stride=1, padding=((0, 0),), dilation=1,
               name=None):
        ins = [x, w] + ([b] if b is not None else [])
        return self._mk("conv1d", ins, self._geom(stride, padding, dilation),
                        name=name)

    def conv3d(self, x, w, b=None, stride=(1, 1, 1),
               padding=((0, 0), (0, 0), (0, 0)), dilation=(1, 1, 1),
               name=None):
        """x [B,D,H,W,C], w [kd,kh,kw,I,O] (reference: SDCNN.conv3d)."""
        ins = [x, w] + ([b] if b is not None else [])
        return self._mk("conv3d", ins, self._geom(stride, padding, dilation),
                        name=name)

    def deconv2d(self, x, w, b=None, stride=(1, 1), padding=((0, 0), (0, 0)),
                 name=None):
        ins = [x, w] + ([b] if b is not None else [])
        return self._mk("deconv2d", ins, self._geom(stride, padding),
                        name=name)

    def spaceToDepth(self, x, blockSize=2, name=None):
        return self._mk("spaceToDepth", [x], {"blockSize": int(blockSize)},
                        name=name)

    def depthToSpace(self, x, blockSize=2, name=None):
        return self._mk("depthToSpace", [x], {"blockSize": int(blockSize)},
                        name=name)

    def spaceToBatch(self, x, blockSize=2, padding=((0, 0), (0, 0)),
                     name=None):
        return self._mk("spaceToBatch", [x],
                        {"blockSize": int(blockSize),
                         "padding": [list(q) for q in padding]}, name=name)

    def batchToSpace(self, x, blockSize=2, crops=((0, 0), (0, 0)),
                     name=None):
        return self._mk("batchToSpace", [x],
                        {"blockSize": int(blockSize),
                         "crops": [list(q) for q in crops]}, name=name)

    def maxPooling2d(self, x, kernel, stride=None, padding=((0, 0), (0, 0)),
                     name=None):
        return self._mk("maxPooling2d", [x],
                        {"kernel": list(kernel),
                         "stride": list(stride or kernel),
                         "padding": [list(p) for p in padding]}, name=name)

    def avgPooling2d(self, x, kernel, stride=None, padding=((0, 0), (0, 0)),
                     count_include_pad=True, name=None):
        return self._mk("avgPooling2d", [x],
                        {"kernel": list(kernel),
                         "stride": list(stride or kernel),
                         "padding": [list(p) for p in padding],
                         "count_include_pad": count_include_pad}, name=name)

    def upsampling2d(self, x, size=(2, 2), name=None):
        return self._mk("upsampling2d", [x], {"size": list(size)}, name=name)

    def im2col(self, x, kernel, stride=(1, 1), padding=((0, 0), (0, 0)),
               name=None):
        return self._mk("im2col", [x],
                        {"kernel": list(kernel), "stride": list(stride),
                         "padding": [list(p) for p in padding]}, name=name)


class _RNNOps(_NS):
    """Reference: ops.SDRNN; time-major x [T, B, F], the reference's gate
    order ([i, f, o, g] for the LSTM, (r, z, n) for the GRU)."""

    def lstmLayer(self, x, w, u, b, name=None):
        """-> (h_seq [T,B,H], h_last [B,H], c_last [B,H])."""
        return self._mk("lstmLayer", [x, w, u, b], nOut=3, name=name)

    def gru(self, x, w, u, b, name=None):
        return self._mk("gru", [x, w, u, b], name=name)

    def simpleRnn(self, x, w, u, b, name=None):
        return self._mk("simpleRnn", [x, w, u, b], name=name)


def _unary(opName):
    def m(self, x, name=None):
        return self._mk(opName, [x], name=name)
    m.__name__ = opName
    return m


def _binary(opName):
    def m(self, a, b, name=None):
        return self._mk(opName, [a, b], name=name)
    m.__name__ = opName
    return m


def _reduction(opName):
    def m(self, x, *dimensions, keepDims=False, name=None):
        return self._mk(opName, [x],
                        {"dimensions": list(dimensions) or None,
                         "keepDims": keepDims}, name=name)
    m.__name__ = opName
    return m


class _MathOps(_NS):
    """Reference: org.nd4j.autodiff.samediff.ops.SDMath."""

    for _n in ("neg abs sign exp expm1 log log1p log2 sqrt square floor ceil "
               "round sin cos tan asin acos atan sinh cosh tanh asinh acosh "
               "atanh erf erfc reciprocal rsqrt isnan isinf isfinite "
               "lgamma digamma").split():
        locals()[_n] = _unary(_n)
    for _n in ("add sub mul div pow atan2 squaredDifference maximum minimum "
               "floordiv mod eq neq gt gte lt lte and or xor "
               "igamma igammac polygamma zeta").split():
        locals()[_n] = _binary(_n)
    for _n in "sum mean prod max min std variance norm1 norm2 normmax".split():
        locals()[_n] = _reduction(_n)
    del _n

    def logicalNot(self, x, name=None):
        return self._mk("not", [x], name=name)

    def betainc(self, a, b, x, name=None):
        """Regularized incomplete beta I_x(a, b) (reference: SDMath)."""
        return self._mk("betainc", [a, b, x], name=name)

    # -- segment reductions (numSegments fixes the output shape) --
    def _seg(self, opName, data, ids, numSegments, name):
        return self._mk(opName, [data, ids], {"numSegments": numSegments},
                        name=name)

    def segmentSum(self, data, segmentIds, numSegments=None, name=None):
        return self._seg("segmentSum", data, segmentIds, numSegments, name)

    def segmentMax(self, data, segmentIds, numSegments=None, name=None):
        return self._seg("segmentMax", data, segmentIds, numSegments, name)

    def segmentMin(self, data, segmentIds, numSegments=None, name=None):
        return self._seg("segmentMin", data, segmentIds, numSegments, name)

    def segmentMean(self, data, segmentIds, numSegments=None, name=None):
        return self._seg("segmentMean", data, segmentIds, numSegments, name)

    def segmentProd(self, data, segmentIds, numSegments=None, name=None):
        return self._seg("segmentProd", data, segmentIds, numSegments, name)

    unsortedSegmentSum = segmentSum      # the ids may come in any order
    unsortedSegmentMax = segmentMax
    unsortedSegmentMin = segmentMin
    unsortedSegmentMean = segmentMean
    unsortedSegmentProd = segmentProd

    # -- reduce3-style distance ops --
    def _dist(self, opName, x, y, dimensions, name):
        return self._mk(opName, [x, y],
                        {"dimensions": list(dimensions) or None}, name=name)

    def cosineSimilarity(self, x, y, *dimensions, name=None):
        return self._dist("cosineSimilarity", x, y, dimensions, name)

    def cosineDistance(self, x, y, *dimensions, name=None):
        return self._dist("cosineDistance", x, y, dimensions, name)

    def euclideanDistance(self, x, y, *dimensions, name=None):
        return self._dist("euclideanDistance", x, y, dimensions, name)

    def manhattanDistance(self, x, y, *dimensions, name=None):
        return self._dist("manhattanDistance", x, y, dimensions, name)

    def hammingDistance(self, x, y, *dimensions, name=None):
        return self._dist("hammingDistance", x, y, dimensions, name)

    def jaccardDistance(self, x, y, *dimensions, name=None):
        return self._dist("jaccardDistance", x, y, dimensions, name)

    def confusionMatrix(self, labels, pred, numClasses=None, weights=None,
                        name=None):
        ins = [labels, pred] + ([weights] if weights is not None else [])
        kw = {"numClasses": numClasses}
        if weights is None:
            return self._mk("confusionMatrix", ins, kw, name=name)
        return self._mk("confusionMatrixWeighted", ins, kw, name=name)

    def zeroFraction(self, x, name=None):
        return self._mk("zeroFraction", [x], name=name)

    def countNonZero(self, x, *dimensions, keepDims=False, name=None):
        return self._mk("countNonZero", [x],
                        {"dimensions": list(dimensions) or None,
                         "keepDims": keepDims}, name=name)

    def countZero(self, x, *dimensions, keepDims=False, name=None):
        return self._mk("countZero", [x],
                        {"dimensions": list(dimensions) or None,
                         "keepDims": keepDims}, name=name)

    def entropy(self, x, *dimensions, name=None):
        return self._mk("entropy", [x],
                        {"dimensions": list(dimensions) or None}, name=name)

    def shannonEntropy(self, x, *dimensions, name=None):
        return self._mk("shannonEntropy", [x],
                        {"dimensions": list(dimensions) or None}, name=name)

    def matchConditionCount(self, x, condition, value, *dimensions,
                            keepDims=False, name=None):
        return self._mk("matchConditionCount", [x],
                        {"condition": condition, "value": float(value),
                         "dimensions": list(dimensions) or None,
                         "keepDims": keepDims}, name=name)

    def iamax(self, x, dimension=None, name=None):
        return self._mk("iamax", [x],
                        {"dimensions": None if dimension is None
                         else [dimension]}, name=name)

    def linspace(self, start, stop, num, dtype="float32", name=None):
        return self._mk("linspace", [],
                        {"start": float(start), "stop": float(stop),
                         "num": int(num), "dtype": numpy_name(dtype)},
                        name=name)

    def range(self, start, limit, delta=1, dtype="float32", name=None):
        return self._mk("range", [],
                        {"start": start, "limit": limit, "delta": delta,
                         "dtype": numpy_name(dtype)}, name=name)

    def meshgrid(self, *xs, indexing="xy", name=None):
        return self._mk("meshgrid", list(xs), {"indexing": indexing},
                        nOut=len(xs), name=name)

    def clipByValue(self, x, clipValueMin, clipValueMax, name=None):
        return self._mk("clipByValue", [x],
                        {"clipValueMin": clipValueMin,
                         "clipValueMax": clipValueMax}, name=name)

    def clipByNorm(self, x, clipValue, *dimensions, name=None):
        return self._mk("clipByNorm", [x],
                        {"clipValue": float(clipValue),
                         "dimensions": list(dimensions) or None}, name=name)

    def sort(self, x, axis=-1, descending=False, name=None):
        return self._mk("sort", [x], {"axis": axis,
                                      "descending": descending}, name=name)

    def topK(self, x, k, sorted=True, name=None):
        """(values, indices) of the k largest along the last axis."""
        return self._mk("topK", [x], {"k": int(k), "sorted": sorted},
                        nOut=2, name=name)

    def split(self, x, numSplit, axis=0, name=None):
        return self._mk("split", [x], {"numSplit": int(numSplit),
                                       "axis": axis}, nOut=int(numSplit),
                        name=name)

    def where(self, cond, x, y, name=None):
        return self._mk("where", [cond, x, y], name=name)

    def argmax(self, x, dimension=None, name=None):
        return self._mk("argmax", [x],
                        {"dimensions": None if dimension is None
                         else [dimension]}, name=name)

    def argmin(self, x, dimension=None, name=None):
        return self._mk("argmin", [x],
                        {"dimensions": None if dimension is None
                         else [dimension]}, name=name)

    def cumsum(self, x, axis=0, exclusive=False, reverse=False, name=None):
        return self._mk("cumsum", [x], {"axis": axis, "exclusive": exclusive,
                                        "reverse": reverse}, name=name)

    def cumprod(self, x, axis=0, name=None):
        return self._mk("cumprod", [x], {"axis": axis}, name=name)

    def concat(self, dimension, *xs, name=None):
        return self._mk("concat", list(xs), {"dimension": dimension},
                        name=name)

    def stack(self, axis, *xs, name=None):
        return self._mk("stack", list(xs), {"axis": axis}, name=name)

    def unstack(self, x, axis, num, name=None):
        return self._mk("unstack", [x], {"axis": axis, "num": num},
                        nOut=num, name=name)

    def reshape(self, x, shape, name=None):
        return self._mk("reshape", [x], {"shape": list(shape)}, name=name)

    def permute(self, x, *dims, name=None):
        return self._mk("permute", [x], {"dimensions": list(dims)}, name=name)

    def expandDims(self, x, axis, name=None):
        return self._mk("expandDims", [x], {"axis": axis}, name=name)

    def squeeze(self, x, axis, name=None):
        return self._mk("squeeze", [x], {"axis": axis}, name=name)

    def tile(self, x, reps, name=None):
        return self._mk("tile", [x], {"reps": list(reps)}, name=name)

    def reverse(self, x, *dimensions, name=None):
        return self._mk("reverse", [x], {"dimensions": list(dimensions)},
                        name=name)

    def gather(self, x, indices, axis=0, name=None):
        return self._mk("gather", [x, indices], {"axis": axis}, name=name)

    def oneHot(self, x, depth, axis=-1, on=1.0, off=0.0, name=None):
        return self._mk("onehot", [x], {"depth": depth, "axis": axis,
                                        "on": on, "off": off}, name=name)

    def scatterUpdate(self, ref, indices, updates, name=None):
        return self._mk("scatterUpdate", [ref, indices, updates], name=name)

    def scatterAdd(self, ref, indices, updates, name=None):
        return self._mk("scatterAdd", [ref, indices, updates], name=name)

    def pad(self, x, padding, constant=0.0, name=None):
        return self._mk("pad", [x], {"padding": [list(p) for p in padding],
                                     "constant": constant}, name=name)

    def identity(self, x, name=None):
        return self._mk("identity", [x], name=name)

    def cast(self, x, dtype, name=None):
        return self._mk("cast", [x], {"dtype": numpy_name(dtype)},
                        name=name)


class _NNOps(_NS):
    """Reference: ops.SDNN."""

    for _n in ("relu relu6 sigmoid softplus softsign elu selu gelu swish "
               "mish hardSigmoid hardTanh").split():
        locals()[_n] = _unary(_n)
    del _n

    def leakyRelu(self, x, alpha=0.01, name=None):
        return self._mk("leakyRelu", [x], {"alpha": alpha}, name=name)

    def softmax(self, x, dimension=-1, name=None):
        return self._mk("softmax", [x], {"dimension": dimension}, name=name)

    def logSoftmax(self, x, dimension=-1, name=None):
        return self._mk("logSoftmax", [x], {"dimension": dimension},
                        name=name)

    def linear(self, x, w, b=None, name=None):
        ins = [x, w] + ([b] if b is not None else [])
        return self._mk("linear", ins, name=name)

    def reluLayer(self, x, w, b, name=None):
        return self.relu(self.linear(x, w, b), name=name)

    def layerNorm(self, x, gain, bias=None, dimensions=(-1,), name=None):
        ins = [x, gain] + ([bias] if bias is not None else [])
        return self._mk("layerNorm", ins,
                        {"dimensions": list(dimensions)}, name=name)

    def batchNorm(self, x, mean, var, gamma=None, beta=None, epsilon=1e-5,
                  axis=-1, name=None):
        ins = [x, mean, var] + ([gamma] if gamma is not None else []) \
            + ([beta] if beta is not None else [])
        return self._mk("batchNorm", ins, {"epsilon": epsilon, "axis": axis},
                        name=name)

    def dropout(self, x, rate, name=None):
        """Active during fit() (train mode and the step's stream);
        identity in output()/eval()."""
        return self._mk("dropout", [x], {"rate": rate}, name=name)

    def embeddingLookup(self, table, ids, name=None):
        return self._mk("embeddingLookup", [table, ids], name=name)

    def dotProductAttention(self, q, k, v, causal=False, name=None):
        return self._mk("dotProductAttention", [q, k, v],
                        {"causal": causal}, name=name)

    def multiHeadDotProductAttention(self, x, wq, wk, wv, wo, nHeads,
                                     causal=False, name=None):
        """x [B, T, E]; wq/wk/wv [E, H*D]; wo [H*D, E]; no bias. The core
        is ``flash_attention``: on the card the kernels K1 (forward) and
        K2/K3 (backward)."""
        return self._mk("multiHeadDotProductAttention",
                        [x, wq, wk, wv, wo],
                        {"nHeads": nHeads, "causal": causal}, name=name)

    def pad(self, x, padding, constant=0.0, name=None):
        return self.sd.math.pad(x, padding, constant, name=name)


class _LossOps(_NS):
    """Reference: ops.SDLoss. Outputs are marked as loss variables."""

    def _loss(self, opName, inputs, kwargs=None, name=None):
        v = self._mk(opName, inputs, kwargs, name=name)
        self.sd._loss_vars.append(v.name)
        return v

    def meanSquaredError(self, labels, predictions, name=None):
        return self._loss("lossMSE", [labels, predictions], name=name)

    def absoluteDifference(self, labels, predictions, name=None):
        return self._loss("lossMAE", [labels, predictions], name=name)

    def logLoss(self, labels, predictions, name=None):
        return self._loss("lossLog", [labels, predictions], name=name)

    def softmaxCrossEntropy(self, labels, logits, name=None):
        return self._loss("softmaxCrossEntropy", [labels, logits], name=name)

    def sparseSoftmaxCrossEntropy(self, labels, logits, name=None):
        return self._loss("sparseSoftmaxCrossEntropy", [labels, logits],
                          name=name)

    def hingeLoss(self, labels, predictions, name=None):
        return self._loss("lossHinge", [labels, predictions], name=name)

    def huberLoss(self, labels, predictions, delta=1.0, name=None):
        return self._loss("lossHuber", [labels, predictions],
                          {"delta": delta}, name=name)

    def klDivergence(self, labels, predictions, name=None):
        return self._loss("lossKLD", [labels, predictions], name=name)

    def poissonLoss(self, labels, predictions, name=None):
        return self._loss("lossPoisson", [labels, predictions], name=name)

    def sigmoidCrossEntropy(self, labels, logits, labelSmoothing=0.0,
                            name=None):
        return self._loss("sigmoidCrossEntropy", [labels, logits],
                          {"labelSmoothing": float(labelSmoothing)},
                          name=name)

    def weightedCrossEntropyWithLogits(self, labels, logits, weights,
                                       name=None):
        return self._loss("weightedCrossEntropyWithLogits",
                          [labels, logits, weights], name=name)

    def l2Loss(self, x, name=None):
        return self._loss("l2Loss", [x], name=name)

    def meanPairwiseSquaredError(self, labels, predictions, name=None):
        return self._loss("meanPairwiseSquaredError",
                          [labels, predictions], name=name)

    def cosineDistance(self, labels, predictions, dimension=-1, name=None):
        return self._loss("lossCosine", [labels, predictions],
                          {"dimension": dimension}, name=name)


class _ImageOps(_NS):
    """Reference: ops.SDImage (NHWC)."""

    def resizeBilinear(self, x, height, width, name=None):
        """``jax.image.resize``'s bilinear: half-pixel centres, and a
        triangle kernel widened when downsampling (antialiased)."""
        return self._mk("resizeBilinear", [x],
                        {"height": height, "width": width}, name=name)

    def resizeNearest(self, x, height, width, name=None):
        return self._mk("resizeNearest", [x],
                        {"height": height, "width": width}, name=name)

    def cropAndResize(self, x, boxes, boxIndices, cropHeight, cropWidth,
                      name=None):
        return self._mk("cropAndResize", [x, boxes, boxIndices],
                        {"cropHeight": cropHeight, "cropWidth": cropWidth},
                        name=name)

    def adjustContrast(self, x, factor, name=None):
        return self._mk("adjustContrast", [x], {"factor": factor}, name=name)

    def hsvToRgb(self, x, name=None):
        return self._mk("hsvToRgb", [x], name=name)

    def rgbToHsv(self, x, name=None):
        return self._mk("rgbToHsv", [x], name=name)

    # the block ops live in sd.cnn (reference: SDCNN), aliased here
    spaceToDepth = _CNNOps.spaceToDepth
    depthToSpace = _CNNOps.depthToSpace
    spaceToBatch = _CNNOps.spaceToBatch
    batchToSpace = _CNNOps.batchToSpace

    def nonMaxSuppression(self, boxes, scores, maxOutputSize=10,
                          iouThreshold=0.5, scoreThreshold=float("-inf"),
                          name=None):
        return self._mk("nonMaxSuppression", [boxes, scores],
                        {"maxOutputSize": int(maxOutputSize),
                         "iouThreshold": float(iouThreshold),
                         "scoreThreshold": float(scoreThreshold)},
                        name=name)


class _LinalgOps(_NS):
    """Reference: ops.SDLinalg."""

    def mmul(self, a, b, transposeA=False, transposeB=False, name=None):
        return self._mk("mmul", [a, b], {"transposeA": transposeA,
                                         "transposeB": transposeB}, name=name)

    def tensorMmul(self, a, b, dimensionsA, dimensionsB, name=None):
        return self._mk("tensorMmul", [a, b],
                        {"dimensionsA": list(dimensionsA),
                         "dimensionsB": list(dimensionsB)}, name=name)

    def matmul(self, a, b, name=None):
        return self._mk("batchMmul", [a, b], name=name)

    for _n in "cholesky inv det trace".split():
        locals()[_n] = _unary(_n)
    for _n in "cross solve lstsq".split():
        locals()[_n] = _binary(_n)
    del _n

    def lu(self, x, name=None):
        """Explicit P, L, U factors with x = P @ L @ U (the reference's
        deliberate change from SDLinalg.lu's packed form)."""
        return self._mk("lu", [x], nOut=3, name=name)

    def eigh(self, x, name=None):
        """Eigenvalues (ascending) and eigenvectors of a symmetric
        matrix."""
        return self._mk("eigh", [x], nOut=2, name=name)

    def svd(self, x, fullUV=False, name=None):
        return self._mk("svd", [x], {"fullUV": fullUV}, nOut=3, name=name)

    def qr(self, x, name=None):
        return self._mk("qr", [x], nOut=2, name=name)


class _FFTOps(_NS):
    """Reference: the Nd4j.fft spectral family; complex64/complex128
    arrays are first-class, real/imag/conj/angle/toComplex convert at
    the boundary."""

    def _spec(self, opName, x, numPoints, dimension, name):
        return self._mk(opName, [x], {"numPoints": numPoints,
                                      "dimension": int(dimension)},
                        name=name)

    def fft(self, x, numPoints=None, dimension=-1, name=None):
        return self._spec("fft", x, numPoints, dimension, name)

    def ifft(self, x, numPoints=None, dimension=-1, name=None):
        return self._spec("ifft", x, numPoints, dimension, name)

    def rfft(self, x, numPoints=None, dimension=-1, name=None):
        """Real input -> the positive-frequency half spectrum."""
        return self._spec("rfft", x, numPoints, dimension, name)

    def irfft(self, x, numPoints=None, dimension=-1, name=None):
        return self._spec("irfft", x, numPoints, dimension, name)

    def fft2(self, x, name=None):
        return self._mk("fft2", [x], name=name)

    def ifft2(self, x, name=None):
        return self._mk("ifft2", [x], name=name)

    for _n in "real imag conj angle".split():
        locals()[_n] = _unary(_n)
    del _n

    def toComplex(self, re, im, name=None):
        return self._mk("toComplex", [re, im], name=name)


class _BitwiseOps(_NS):
    """Reference: ops.SDBitwise. uint16/uint32 run widened exactly;
    uint64 shifts are refused (``ops_impl``)."""

    def leftShift(self, a, b, name=None):
        return self._mk("shiftLeft", [a, b], name=name)

    def rightShift(self, a, b, name=None):
        return self._mk("shiftRight", [a, b], name=name)

    def bitwiseAnd(self, a, b, name=None):
        return self._mk("bitwiseAnd", [a, b], name=name)

    def bitwiseOr(self, a, b, name=None):
        return self._mk("bitwiseOr", [a, b], name=name)

    def bitwiseXor(self, a, b, name=None):
        return self._mk("bitwiseXor", [a, b], name=name)

    def bitwiseNot(self, x, name=None):
        return self._mk("bitwiseNot", [x], name=name)


class _RandomOps(_NS):
    """Reference: ops.SDRandom. Draws are refreshed per fit() step and
    fixed for output(); not differentiable."""

    def normal(self, mean, stddev, *shape, name=None):
        return self._mk("randomNormal", [],
                        {"shape": tuple(int(s) for s in shape),
                         "mean": float(mean), "stddev": float(stddev)},
                        name=name)

    def uniform(self, min, max, *shape, name=None):
        return self._mk("randomUniform", [],
                        {"shape": tuple(int(s) for s in shape),
                         "min": float(min), "max": float(max)}, name=name)

    def bernoulli(self, p, *shape, name=None):
        return self._mk("randomBernoulli", [],
                        {"shape": tuple(int(s) for s in shape),
                         "p": float(p)}, name=name)

    def exponential(self, lambda_, *shape, name=None):
        return self._mk("randomExponential", [],
                        {"shape": tuple(int(s) for s in shape),
                         "lambda_": float(lambda_)}, name=name)
