"""Attention layer configurations.

The counterpart of ``deeplearning4j_tpu/nn/conf/attention.py``:
``SelfAttentionLayer``, ``LearnedSelfAttentionLayer``,
``RecurrentAttentionLayer`` and ``AttentionVertex``. Data between layers
stays NCW ``[B, F, T]``; the attention math runs ``[B, T, F]`` inside.

``_mha_apply`` projects q/k/v with ``torch.matmul``, views them as
``[B, H, T, D]`` (a transpose, no copy: the flash kernels read through
the strides) and calls ``ops.flash_attention.flash_attention``, which on
the card runs the hand-written kernels K1 and, under autograd, K2/K3.
The vertex's 3-input form and ``projectInput=False`` use
``dot_product_attention``, as in the reference.

Masks follow the reference: the feature mask [B, T] marks valid KEY
timesteps; masked query positions are zeroed in the output.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import weights as _winit
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import FeedForwardLayer
from deeplearning4j_tpu_torch.ops import attention as _attn
from deeplearning4j_tpu_torch.ops import flash_attention as _flash

__all__ = ["SelfAttentionLayer", "LearnedSelfAttentionLayer",
           "RecurrentAttentionLayer", "AttentionVertex"]


def _mha_params(gen, nIn, nHeads, headSize, nOut, weightInit, dtype, device,
                distribution, with_bias=False, query_nIn=None):
    """Wq/Wk/Wv project to [nHeads*headSize]; Wo projects back to nOut."""
    E, P = nIn, nHeads * headSize
    Eq = query_nIn if query_nIn is not None else nIn

    def w(shape):
        return _winit.init(gen, weightInit, shape, shape[0], shape[1], dtype,
                           device, distribution)

    p = {"Wq": w((Eq, P)), "Wk": w((E, P)), "Wv": w((E, P)),
         "Wo": w((P, nOut))}
    if with_bias:
        for k, n in (("bq", P), ("bk", P), ("bv", P), ("bo", nOut)):
            p[k] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def _project(x, W, b):
    y = x @ W
    return y if b is None else y + b


def _heads(x, B, T, nHeads):
    """[B, T, H*D] -> [B, H, T, D] as a view."""
    return x.reshape(B, T, nHeads, -1).transpose(1, 2)


def _mha_apply(params, q_btf, kv_btf, nHeads, mask=None, block_size=None,
               group=None, out_proj=None):
    """q [B,Tq,Eq], kv [B,Tk,E] -> [B,Tq,nOut]. mask: [B,Tk] key validity.

    Under tensor parallelism (`group`, the model axis of m ranks;
    ``parallel.tensor``) Wq/Wk/Wv and their biases are this rank's
    column blocks, which hold heads [r·nHeads/m, (r+1)·nHeads/m): the
    inputs go in behind ``copy_to``, the kernels run on nHeads/m heads
    and the heads' outputs are gathered before the output projection,
    ``out_proj(o)`` (default: ``o @ Wo + bo``)."""
    B, Tq, _ = q_btf.shape
    Tk = kv_btf.shape[1]
    if group is not None:
        from deeplearning4j_tpu_torch.parallel import collectives as _coll

        same = kv_btf is q_btf
        q_btf = _coll.copy_to(q_btf, group)
        kv_btf = q_btf if same else _coll.copy_to(kv_btf, group)
        nHeads //= group.size
    q = _heads(_project(q_btf, params["Wq"], params.get("bq")), B, Tq, nHeads)
    k = _heads(_project(kv_btf, params["Wk"], params.get("bk")), B, Tk, nHeads)
    v = _heads(_project(kv_btf, params["Wv"], params.get("bv")), B, Tk, nHeads)
    key_mask = None if mask is None else mask > 0
    if block_size:
        # an explicit blockSize bounds attention memory: never the fused form
        o = _flash.flash_attention(q, k, v, key_mask=key_mask,
                                   block_k=block_size, force_streaming=True)
    else:
        o = _flash.flash_attention(q, k, v, key_mask=key_mask)
    o = o.transpose(1, 2).reshape(B, Tq, -1)
    if group is not None:
        o = _coll.gather_from(o, group, -1)
    if out_proj is not None:
        return out_proj(o)
    return _project(o, params["Wo"], params.get("bo"))


class SelfAttentionLayer(FeedForwardLayer):
    """Multi-head dot-product self-attention over the input sequence
    (reference: conf.layers.SelfAttentionLayer). NCW [B, F, T] ->
    [B, nOut, T]. projectInput=False requires nHeads == 1 and nOut == nIn
    (raw attention, no parameters)."""

    def __init__(self, nHeads=1, headSize=None, projectInput=True,
                 hasBias=False, blockSize=None, **kw):
        super().__init__(**kw)
        self.nHeads = int(nHeads)
        self.headSize = headSize
        self.projectInput = projectInput
        self.hasBias = hasBias
        self.blockSize = blockSize

    def getOutputType(self, inputType):
        n = self.nOut if (self.projectInput and self.nOut) else inputType.size
        self.nOut = n
        return InputType.recurrent(n, inputType.dims.get("timeSeriesLength"))

    def initialize(self, gen, inputType, dtype, device):
        if self.nIn is None:
            self.nIn = inputType.size
        if not self.projectInput:
            if self.nHeads != 1:
                raise ValueError("projectInput=False requires nHeads=1 "
                                 "(reference: SelfAttentionLayer)")
            self.nOut = self.nIn
            return {}, {}
        if self.nOut is None:
            self.nOut = self.nIn
        if self.headSize is None:
            if self.nOut % self.nHeads:
                raise ValueError(f"nOut={self.nOut} not divisible by "
                                 f"nHeads={self.nHeads}; set headSize")
            self.headSize = self.nOut // self.nHeads
        return _mha_params(gen, self.nIn, self.nHeads, self.headSize,
                           self.nOut, self.weightInit, dtype, device,
                           self.distribution, self.hasBias), {}

    def hasParams(self):
        return self.projectInput

    def forward(self, params, state, x, train, gen, mask=None):
        x = self._dropout_input(x, train, gen)
        xt = x.transpose(1, 2)  # NCW -> [B,T,F]
        if self.projectInput:
            y = _mha_apply(params, xt, xt, self.nHeads, mask=mask,
                           block_size=self.blockSize)
        else:
            q = xt[:, None]  # [B,1,T,F]: single "head"
            amask = None if mask is None else (mask > 0)[:, None, None, :]
            y = _attn.dot_product_attention(q, q, q, mask=amask)[:, 0]
        if mask is not None:
            y = y * mask[:, :, None]  # zero masked query positions
        y = _act.get(self.activation)(y)
        return y.transpose(1, 2), state


class LearnedSelfAttentionLayer(SelfAttentionLayer):
    """Attention with nQueries LEARNED query vectors pooling the sequence
    to a fixed-length output (reference:
    conf.layers.LearnedSelfAttentionLayer). [B, F, T] -> [B, nOut, nQueries].
    """

    def __init__(self, nQueries=1, **kw):
        super().__init__(**kw)
        self.nQueries = int(nQueries)

    def getOutputType(self, inputType):
        n = self.nOut if (self.projectInput and self.nOut) else inputType.size
        self.nOut = n
        return InputType.recurrent(n, self.nQueries)

    def initialize(self, gen, inputType, dtype, device):
        params, state = super().initialize(gen, inputType, dtype, device)
        # learned queries live in input space, like the reference's Q param
        params = dict(params)
        params["Q"] = _winit.init(gen, self.weightInit,
                                  (self.nQueries, self.nIn), self.nIn,
                                  self.nQueries, dtype, device,
                                  self.distribution)
        return params, state

    def hasParams(self):
        return True

    def forward(self, params, state, x, train, gen, mask=None):
        x = self._dropout_input(x, train, gen)
        xt = x.transpose(1, 2)  # [B,T,F]
        B = xt.shape[0]
        q = params["Q"][None].expand((B,) + tuple(params["Q"].shape))
        if self.projectInput:
            y = _mha_apply(params, q, xt, self.nHeads, mask=mask,
                           block_size=self.blockSize)
        else:
            kh = xt[:, None]
            amask = None if mask is None else (mask > 0)[:, None, None, :]
            y = _attn.dot_product_attention(q[:, None], kh, kh,
                                            mask=amask)[:, 0]
        y = _act.get(self.activation)(y)
        return y.transpose(1, 2), state  # [B,nOut,nQueries]


class RecurrentAttentionLayer(FeedForwardLayer):
    """Recurrent layer whose step combines the current input with
    attention over the full input sequence, queried by the previous
    hidden state (reference: conf.layers.RecurrentAttentionLayer):

        attn_t = MHA(q = a_{t-1}, k = v = x)
        a_t    = activation(x_t @ W + attn_t @ R + b)

    [B, F, T] -> [B, nOut, T]. The K/V projections of the whole sequence
    are hoisted out of the step loop.
    """

    def __init__(self, nHeads=1, headSize=None, hasBias=True, **kw):
        super().__init__(**kw)
        self.nHeads = int(nHeads)
        self.headSize = headSize
        self.hasBias = hasBias
        if self.activation is None:
            self.activation = "tanh"

    def mergeGlobals(self, defaults):
        act_before = self.activation
        super().mergeGlobals(defaults)
        if act_before is not None:
            self.activation = act_before

    def getOutputType(self, inputType):
        return InputType.recurrent(self.nOut,
                                   inputType.dims.get("timeSeriesLength"))

    def initialize(self, gen, inputType, dtype, device):
        if self.nIn is None:
            self.nIn = inputType.size
        H = self.nOut
        if self.headSize is None:
            if H % self.nHeads:
                raise ValueError(
                    f"nOut={H} not divisible by nHeads={self.nHeads}")
            self.headSize = H // self.nHeads
        params = _mha_params(gen, self.nIn, self.nHeads, self.headSize, H,
                             self.weightInit, dtype, device,
                             self.distribution, query_nIn=H)
        params["W"] = _winit.init(gen, self.weightInit, (self.nIn, H),
                                  self.nIn, H, dtype, device,
                                  self.distribution)
        params["R"] = _winit.init(gen, self.weightInit, (H, H), H, H, dtype,
                                  device, self.distribution)
        if self.hasBias:
            params["b"] = torch.zeros((H,), dtype=dtype, device=device)
        return params, {}

    def forward(self, params, state, x, train, gen, mask=None):
        x = self._dropout_input(x, train, gen)
        xt = x.transpose(1, 2)                    # [B,T,F]
        B, T, _ = xt.shape
        H, nh = self.nOut, self.nHeads
        k = _heads(xt @ params["Wk"], B, T, nh)
        v = _heads(xt @ params["Wv"], B, T, nh)
        xW = xt @ params["W"]                     # [B,T,H]
        if self.hasBias:
            xW = xW + params["b"]
        amask = None if mask is None else (mask > 0)[:, None, None, :]
        act = _act.get(self.activation)
        a = state.get("h") if state else None
        if a is None:
            a = torch.zeros((B, H), dtype=xt.dtype, device=xt.device)
        ys = []
        for t in range(T):
            q = _heads((a @ params["Wq"])[:, None], B, 1, nh)
            o = _attn.dot_product_attention(q, k, v, mask=amask)
            o = o.transpose(1, 2).reshape(B, -1) @ params["Wo"]  # [B,H]
            a = act(xW[:, t] + o @ params["R"])
            ys.append(a)
        y = torch.stack(ys, dim=2)                # [B,H,T]
        if mask is not None:
            y = y * mask[:, None, :]
        return y, {**(state or {}), "h": a}


class AttentionVertex(FeedForwardLayer):
    """General multi-head attention DAG vertex (reference:
    conf.graph.AttentionVertex), added with ``addVertex("attn",
    AttentionVertex(...), queries[, keys[, values]])``: 1 input is
    self-attention, 2 are (queries, keyvalues), 3 are (queries, keys,
    values). Sequence inputs are NCW; the output is [B, nOut, Tq]. It
    owns projection weights, so the executor runs it as a multi-input
    layer node."""

    multiInput = True

    def __init__(self, nInQueries=None, nInKeys=None, nInValues=None,
                 nHeads=1, headSize=None, projectInput=True, nOut=None,
                 hasBias=False, blockSize=None, **kw):
        super().__init__(nOut=nOut, **kw)
        self.nInQueries, self.nInKeys, self.nInValues = \
            nInQueries, nInKeys, nInValues
        self.nHeads = int(nHeads)
        self.headSize = headSize
        self.projectInput = projectInput
        self.hasBias = hasBias
        self.blockSize = blockSize

    def getOutputType(self, *inputTypes):
        qt = inputTypes[0]
        n = self.nOut if (self.projectInput and self.nOut) else qt.size
        self.nOut = n
        return InputType.recurrent(n, qt.dims.get("timeSeriesLength"))

    def inferNIn(self, *inputTypes):
        qt = inputTypes[0]
        kt = inputTypes[1] if len(inputTypes) > 1 else qt
        if self.nInQueries is None:
            self.nInQueries = qt.size
        if self.nInKeys is None:
            self.nInKeys = kt.size
        if self.nInValues is None:
            self.nInValues = (inputTypes[2] if len(inputTypes) > 2
                              else kt).size

    def initialize(self, gen, inputType, dtype, device):
        its = inputType if isinstance(inputType, (list, tuple)) \
            else [inputType]
        self.inferNIn(*its)
        if not self.projectInput:
            if self.nHeads != 1:
                raise ValueError("projectInput=False requires nHeads=1")
            self.nOut = self.nInQueries
            return {}, {}
        if self.nOut is None:
            self.nOut = self.nInQueries
        if self.headSize is None:
            if self.nOut % self.nHeads:
                raise ValueError(f"nOut={self.nOut} not divisible by "
                                 f"nHeads={self.nHeads}; set headSize")
            self.headSize = self.nOut // self.nHeads
        return _mha_params(gen, self.nInKeys, self.nHeads, self.headSize,
                           self.nOut, self.weightInit, dtype, device,
                           self.distribution, self.hasBias,
                           query_nIn=self.nInQueries), {}

    def hasParams(self):
        return self.projectInput

    def forward(self, params, state, xs, train, gen, mask=None):
        xs = xs if isinstance(xs, (list, tuple)) else [xs]
        qt = xs[0].transpose(1, 2)
        kvt = (xs[1] if len(xs) > 1 else xs[0]).transpose(1, 2)
        if len(xs) > 2:
            # distinct values input: project V from it, K from keys input
            vt = xs[2].transpose(1, 2)
            B, Tq, Tk, nh = qt.shape[0], qt.shape[1], kvt.shape[1], self.nHeads
            qp = _heads(_project(qt, params["Wq"], params.get("bq")), B, Tq, nh)
            kp = _heads(_project(kvt, params["Wk"], params.get("bk")), B, Tk, nh)
            vp = _heads(_project(vt, params["Wv"], params.get("bv")), B, Tk, nh)
            amask = None if mask is None else (mask > 0)[:, None, None, :]
            o = _attn.dot_product_attention(qp, kp, vp, mask=amask)
            y = _project(o.transpose(1, 2).reshape(B, Tq, -1),
                         params["Wo"], params.get("bo"))
        elif self.projectInput:
            y = _mha_apply(params, qt, kvt, self.nHeads, mask=mask,
                           block_size=self.blockSize)
        else:
            amask = None if mask is None else (mask > 0)[:, None, None, :]
            y = _attn.dot_product_attention(qt[:, None], kvt[:, None],
                                            kvt[:, None], mask=amask)[:, 0]
        y = _act.get(self.activation)(y)
        return y.transpose(1, 2), state
