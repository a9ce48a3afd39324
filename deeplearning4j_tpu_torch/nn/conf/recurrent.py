"""Recurrent layer configurations.

The counterpart of ``deeplearning4j_tpu/nn/conf/recurrent.py``:
``BaseRecurrentLayer``, ``LSTM``, ``GravesLSTM`` (peepholes),
``SimpleRnn``, ``GRU``, the ``Bidirectional`` wrapper (CONCAT, ADD,
MUL, AVERAGE), ``GravesBidirectionalLSTM`` and ``LastTimeStep``. The
cells are ``ops/rnn.py``'s: one input-projection product for all
timesteps, then a loop that carries only the recurrent product.

Activations between layers are the reference's NCW ``[B, F, T]``; a layer
transposes to time-major once at its boundary. Each layer returns its
final carry in its state under ``"h"`` (and ``"c"`` for the LSTMs), and
starts from the carry its state holds: the network decides whether to
feed it back (truncated BPTT, ``rnnTimeStep``) or strip it (standard
backprop). At masked timesteps the outputs are zeroed but the carry goes
on through them, as in the reference.

Parameters keep the reference's names and layouts (``W [nIn, G]``,
``RW [H, G]``, ``b [G]``, gates ``[i, f, o, g]``), so the layout maps
are the identity. A wrapper's parameters are one flat dict with dotted
names (``Bidirectional``'s ``"fwd.W"``, ``"bwd.RW"``, ...) where the
reference nests ``{"fwd": {...}, "bwd": {...}}``; the network's carry
(``multilayer.carry_layer``) flattens and nests them.
"""

from __future__ import annotations

import copy

import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import weights as _winit
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import FeedForwardLayer
from deeplearning4j_tpu_torch.ops import rnn as _rnn

__all__ = ["BaseRecurrentLayer", "LSTM", "GravesLSTM", "SimpleRnn", "GRU",
           "Bidirectional", "GravesBidirectionalLSTM", "LastTimeStep"]


def _to_ncw(ys, mask):
    """Time-major outputs [T, B, H] -> [B, H, T], zeroed where the [B, T]
    mask is 0."""
    if mask is not None:
        ys = ys * mask.t().to(ys.dtype)[:, :, None]
    return ys.permute(1, 2, 0)


class BaseRecurrentLayer(FeedForwardLayer):
    def __init__(self, nOut=None, nIn=None, activation="tanh",
                 gateActivationFn="sigmoid", forgetGateBiasInit=1.0, **kw):
        super().__init__(nIn=nIn, nOut=nOut, **kw)
        if self.activation is None:
            self.activation = activation
        self.gateActivationFn = gateActivationFn
        self.forgetGateBiasInit = forgetGateBiasInit

    def getOutputType(self, inputType):
        return InputType.recurrent(self.nOut,
                                   inputType.dims.get("timeSeriesLength"))

    def mergeGlobals(self, defaults):
        # recurrent layers keep tanh, not the net's global activation
        act_before = self.activation
        super().mergeGlobals(defaults)
        if act_before is not None:
            self.activation = act_before

    def _weights(self, gen, inputType, dtype, device, gates):
        """(W [nIn, gates*H], RW [H, gates*H]) under the layer's init."""
        if self.nIn is None:
            self.nIn = inputType.size
        H = self.nOut
        W = _winit.init(gen, self.weightInit, (self.nIn, gates * H),
                        self.nIn, H, dtype, device, self.distribution)
        RW = _winit.init(gen, self.weightInit, (H, gates * H), H, H, dtype,
                         device, self.distribution)
        return W, RW

    @staticmethod
    def _time_major(x):
        return x.permute(2, 0, 1)   # [B, F, T] -> [T, B, F]


class LSTM(BaseRecurrentLayer):
    """LSTM without peepholes (reference: conf.layers.LSTM)."""

    _peephole = False

    def initialize(self, gen, inputType, dtype, device):
        W, RW = self._weights(gen, inputType, dtype, device, 4)
        H = self.nOut
        b = torch.zeros((4 * H,), dtype=dtype, device=device)
        b[H:2 * H] = self.forgetGateBiasInit   # [i, f, o, g]
        params = {"W": W, "RW": RW, "b": b}
        if self._peephole:
            for k in ("pi", "pf", "po"):
                params[k] = torch.zeros((H,), dtype=dtype, device=device)
        return params, {}

    def forward(self, params, state, x, train, gen, mask=None):
        x = self._dropout_input(x, train, gen)
        state = state or {}
        peep = (params["pi"], params["pf"], params["po"]) \
            if self._peephole else None
        ys, (h, c) = _rnn.lstm_scan(
            self._time_major(x), params["W"], params["RW"], params["b"],
            h0=state.get("h"), c0=state.get("c"), peephole=peep,
            activation=_act.get(self.activation),
            gate_activation=_act.get(self.gateActivationFn))
        return _to_ncw(ys, mask), {**state, "h": h, "c": c}


class GravesLSTM(LSTM):
    """LSTM with peephole connections (reference: conf.layers.GravesLSTM,
    Graves 2013)."""

    _peephole = True


class SimpleRnn(BaseRecurrentLayer):
    def initialize(self, gen, inputType, dtype, device):
        W, RW = self._weights(gen, inputType, dtype, device, 1)
        return {"W": W, "RW": RW,
                "b": torch.zeros((self.nOut,), dtype=dtype,
                                 device=device)}, {}

    def forward(self, params, state, x, train, gen, mask=None):
        x = self._dropout_input(x, train, gen)
        state = state or {}
        ys, h = _rnn.simple_rnn_scan(
            self._time_major(x), params["W"], params["RW"], params["b"],
            h0=state.get("h"), activation=_act.get(self.activation))
        return _to_ncw(ys, mask), {**state, "h": h}


class GRU(BaseRecurrentLayer):
    """GRU, gates packed (r, z, n) (reference: conf.recurrent.GRU)."""

    def initialize(self, gen, inputType, dtype, device):
        W, RW = self._weights(gen, inputType, dtype, device, 3)
        return {"W": W, "RW": RW,
                "b": torch.zeros((3 * self.nOut,), dtype=dtype,
                                 device=device)}, {}

    def forward(self, params, state, x, train, gen, mask=None):
        x = self._dropout_input(x, train, gen)
        state = state or {}
        ys, h = _rnn.gru_scan(
            self._time_major(x), params["W"], params["RW"], params["b"],
            h0=state.get("h"), activation=_act.get(self.activation),
            gate_activation=_act.get(self.gateActivationFn))
        return _to_ncw(ys, mask), {**state, "h": h}


def _split(params, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items()
            if k.startswith(prefix + ".")}


class Bidirectional(FeedForwardLayer):
    """Runs a recurrent layer in both directions (reference:
    conf.layers.recurrent.Bidirectional; modes CONCAT/ADD/MUL/AVERAGE).
    The backward direction reads the PADDED sequence and its mask flipped
    as a whole, as the reference does."""

    CONCAT, ADD, MUL, AVERAGE = "concat", "add", "mul", "average"

    def __init__(self, layer=None, mode="concat", **kw):
        super().__init__(**kw)
        if layer is None:
            raise ValueError("Bidirectional requires an inner recurrent "
                             "layer")
        self.layer = layer
        self.mode = str(mode).lower()
        self.nOut = None
        if self.nIn is None:
            self.nIn = getattr(layer, "nIn", None)

    def mergeGlobals(self, defaults):
        super().mergeGlobals(defaults)
        self.layer.mergeGlobals(defaults)

    def getOutputType(self, inputType):
        inner = self.layer.getOutputType(inputType)
        self.nOut = inner.size * 2 if self.mode == self.CONCAT \
            else inner.size
        return InputType.recurrent(self.nOut,
                                   inputType.dims.get("timeSeriesLength"))

    def initialize(self, gen, inputType, dtype, device):
        self._bwd_layer = copy.deepcopy(self.layer)
        pf, sf = self.layer.initialize(gen, inputType, dtype, device)
        pb, sb = self._bwd_layer.initialize(gen, inputType, dtype, device)
        self.nOut = self.layer.nOut * 2 if self.mode == self.CONCAT \
            else self.layer.nOut
        params = {**{f"fwd.{k}": v for k, v in pf.items()},
                  **{f"bwd.{k}": v for k, v in pb.items()}}
        return params, {"fwd": sf, "bwd": sb}

    def _inner(self, name):
        head, rest = name.split(".", 1)
        return (self.layer if head == "fwd" else self._bwd_layer), rest

    def param_from_reference(self, name, t):
        layer, rest = self._inner(name)
        return layer.param_from_reference(rest, t)

    def param_to_reference(self, name, t):
        layer, rest = self._inner(name)
        return layer.param_to_reference(rest, t)

    def regularization(self, params):
        return (self.layer.regularization(_split(params, "fwd"))
                + self._bwd_layer.regularization(_split(params, "bwd")))

    def forward(self, params, state, x, train, gen, mask=None):
        state = state or {}
        # each direction draws from its own sub-key (the reference's
        # fold_in(key, 0) and fold_in(key, 1))
        gf = None if gen is None else gen.fold(0)
        gb = None if gen is None else gen.fold(1)
        yf, sf = self.layer.forward(_split(params, "fwd"),
                                    state.get("fwd", {}), x, train, gf,
                                    mask)
        m_rev = None if mask is None else mask.flip(1)
        yb, sb = self._bwd_layer.forward(_split(params, "bwd"),
                                         state.get("bwd", {}), x.flip(2),
                                         train, gb, m_rev)
        yb = yb.flip(2)
        if self.mode == self.CONCAT:
            y = torch.cat([yf, yb], dim=1)
        elif self.mode == self.ADD:
            y = yf + yb
        elif self.mode == self.MUL:
            y = yf * yb
        else:
            y = 0.5 * (yf + yb)
        return y, {"fwd": sf, "bwd": sb}


class GravesBidirectionalLSTM(Bidirectional):
    """Bidirectional(GravesLSTM(...), mode=ADD) with a flat constructor
    (reference: conf.layers.GravesBidirectionalLSTM, which sums the two
    directions). Pass mode="CONCAT" for the width-doubling variant."""

    def __init__(self, nIn=None, nOut=None, mode="ADD", **kw):
        super().__init__(layer=GravesLSTM(nIn=nIn, nOut=nOut, **kw),
                         mode=mode)


class LastTimeStep(FeedForwardLayer):
    """Wraps a recurrent layer and emits only its last (unmasked)
    timestep as feed-forward data (reference:
    conf.layers.recurrent.LastTimeStep). Its parameters are the inner
    layer's."""

    def __init__(self, layer=None, **kw):
        super().__init__(**kw)
        if layer is None:
            raise ValueError("LastTimeStep requires an inner recurrent "
                             "layer")
        self.layer = layer
        self.nOut = None

    def mergeGlobals(self, defaults):
        super().mergeGlobals(defaults)
        self.layer.mergeGlobals(defaults)

    def getOutputType(self, inputType):
        self.nOut = self.layer.getOutputType(inputType).size
        return InputType.feedForward(self.nOut)

    def initialize(self, gen, inputType, dtype, device):
        return self.layer.initialize(gen, inputType, dtype, device)

    def param_from_reference(self, name, t):
        return self.layer.param_from_reference(name, t)

    def param_to_reference(self, name, t):
        return self.layer.param_to_reference(name, t)

    def forward(self, params, state, x, train, gen, mask=None):
        y, s = self.layer.forward(params, state, x, train, gen, mask)
        if mask is None:
            return y[:, :, -1], s
        # the last unmasked step of each row; an all-masked row wraps to
        # the last step, as the reference's negative index does
        idx = torch.remainder(mask.sum(1).long() - 1, y.shape[2])
        out = y.gather(2, idx[:, None, None].expand(-1, y.shape[1], 1))
        return out[:, :, 0], s
