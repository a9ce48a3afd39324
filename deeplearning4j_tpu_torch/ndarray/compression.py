"""NDArray buffer compression and post-training int8 weight quantization.

The counterpart of ``deeplearning4j_tpu/ndarray/compression.py``
(reference: nd4j-api ``BasicNDArrayCompressor`` / ``Nd4j.getCompressor()``:
named buffer codecs with compress/decompress and a process-wide default).
The codecs are the port's own copy of the reference's host-side numpy
code, size-0 and below-threshold guards included, so a payload is the
reference's byte for byte.

``threshold_encode_fixed`` is the trainer's fixed-capacity Strom
encoder over a tensor on its device. The reference takes the top-``cap``
magnitudes with ``lax.top_k``, which breaks ties by the lower index;
``torch.topk`` on the card promises no order among ties, so the port
takes a stable descending sort, which keeps tied magnitudes in index
order.

``quantize_int8``/``dequantize``/``quantized_bytes`` work over nested
dicts, lists and tuples of tensors (the networks' parameter trees), and
``Int8Inference`` runs a port network's forward on dequantized weights.
"""

from __future__ import annotations

import math
import zlib
from typing import NamedTuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray.ndarray import INDArray, to_numpy

__all__ = ["BasicNDArrayCompressor", "CompressedNDArray", "Int8Inference",
           "QLeaf", "threshold_cap", "threshold_encode_fixed",
           "quantize_int8", "dequantize", "quantized_bytes"]

_ALGOS = ("GZIP", "FLOAT16", "INT8", "THRESHOLD", "NOOP")


def _host(arr) -> np.ndarray:
    if isinstance(arr, INDArray):
        return arr.toNumpy()
    if isinstance(arr, torch.Tensor):
        return to_numpy(arr)
    return np.asarray(arr)


# ---------------------------------------------------------------------
# Strom-2015 threshold encoding (shared by the trainer step + codec)
# ---------------------------------------------------------------------

def threshold_cap(n: int, capacity: float) -> int:
    """The static per-leaf encoding capacity: how many (index, sign)
    pairs one replica may transmit for an n-element leaf."""
    return max(1, min(int(n), int(math.ceil(float(n) * float(capacity)))))


def threshold_encode_fixed(flat, tau, cap):
    """Fixed-capacity Strom threshold encoding of ONE flat vector.

    The top-`cap` entries of |flat| are candidates (ties in index
    order); those with |value| >= tau transmit as +-tau, the rest
    transmit nothing. Returns

        idx[cap] int32   candidate positions (top-|.| order)
        val[cap]         +-tau where transmitted, 0 where below tau
        dense[n]         the dense equivalent of the wire message
        residual[n]      flat - dense, the error feedback; dense +
                         residual == flat bitwise.
    """
    tau = torch.as_tensor(tau, device=flat.device).to(flat.dtype)
    order = torch.sort(torch.abs(flat), descending=True, stable=True).indices
    idx = order[:int(cap)]
    cand = flat[idx]
    hit = torch.abs(cand) >= tau
    val = torch.where(hit, torch.sign(cand) * tau,
                      torch.zeros((), dtype=flat.dtype, device=flat.device))
    dense = torch.zeros_like(flat).index_put_((idx,), val)
    return idx.to(torch.int32), val, dense, flat - dense


class CompressedNDArray:
    """Opaque compressed buffer + the descriptor needed to restore it
    (upstream: a compressed INDArray flagged by its CompressionDescriptor)."""

    def __init__(self, algo, payload, shape, dtype, extra=None):
        self.algo = algo
        self.payload = payload
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.extra = extra  # per-algo sidecar (e.g. int8 scale)

    def isCompressed(self):
        return True

    def compressedBytes(self):
        n = len(self.payload) if isinstance(self.payload, bytes) \
            else self.payload.nbytes
        if isinstance(self.extra, dict):
            n += sum(np.asarray(v).nbytes for v in self.extra.values())
        elif self.extra is not None:
            n += np.asarray(self.extra).nbytes
        return n

    def originalBytes(self):
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def ratio(self):
        return self.compressedBytes() / max(self.originalBytes(), 1)

    def __repr__(self):
        return (f"CompressedNDArray(algo={self.algo}, shape={self.shape}, "
                f"ratio={self.ratio():.3f})")


class BasicNDArrayCompressor:
    """`Nd4j.getCompressor()` parity surface.

    GZIP      lossless zlib over the raw buffer
    FLOAT16   cast to f16 (lossy), restored to the original float dtype
    INT8      per-tensor absmax affine int8 (lossy), scale in the sidecar
    THRESHOLD Strom-2015 sparse sign encoding (lossy): indices of
              |x| >= tau as int32 + one sign byte each, decoded dense as
              +-tau — the wire format of the trainer's
              gradient_compression="threshold" step (the same encoder,
              see threshold_encode_fixed), testable host-side in
              isolation
    NOOP      descriptor-only identity (upstream ships one; useful to
              exercise the codec path with zero loss)
    """

    _instance = None

    @classmethod
    def getInstance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self):
        self._default = "GZIP"

    def getAvailableCompressors(self):
        return list(_ALGOS)

    def setDefaultCompression(self, algo):
        algo = str(algo).upper()
        if algo not in _ALGOS:
            raise ValueError(f"unknown compressor {algo!r}; "
                             f"available: {_ALGOS}")
        self._default = algo
        return self

    def getDefaultCompression(self):
        return self._default

    def compress(self, arr, algo=None, threshold=1e-3):
        algo = (algo or self._default).upper()
        if algo not in _ALGOS:
            raise ValueError(f"unknown compressor {algo!r}; "
                             f"available: {_ALGOS}")
        x = _host(arr)
        if algo == "THRESHOLD":
            if not np.issubdtype(x.dtype, np.floating):
                raise ValueError("THRESHOLD compression needs a float "
                                 "array")
            tau = float(threshold)
            if tau <= 0:
                raise ValueError(f"threshold must be > 0, got {tau}")
            flat = np.ascontiguousarray(x).reshape(-1)
            # size-0 and all-below-tau short-circuit: an empty index set
            # is a valid (maximally sparse) message, not an error
            idx = (np.flatnonzero(np.abs(flat) >= tau).astype(np.int32)
                   if flat.size else np.zeros((0,), np.int32))
            signs = np.sign(flat[idx]).astype(np.int8)
            return CompressedNDArray(
                algo, signs, x.shape, x.dtype,
                extra={"threshold": np.float32(tau), "indices": idx})
        if algo == "GZIP":
            return CompressedNDArray(
                algo, zlib.compress(np.ascontiguousarray(x).tobytes(), 6),
                x.shape, x.dtype)
        if algo == "FLOAT16":
            if not np.issubdtype(x.dtype, np.floating):
                raise ValueError("FLOAT16 compression needs a float array")
            return CompressedNDArray(algo, x.astype(np.float16),
                                     x.shape, x.dtype)
        if algo == "INT8":
            if not np.issubdtype(x.dtype, np.floating):
                raise ValueError("INT8 compression needs a float array")
            # size-0 arrays short-circuit: np.max of an empty array is a
            # bare numpy ValueError, not a codec answer (ADVICE r5 #5)
            scale = (float(np.max(np.abs(x))) / 127.0 or 1.0) \
                if x.size else 1.0
            q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
            return CompressedNDArray(algo, q, x.shape, x.dtype,
                                     extra=np.float32(scale))
        return CompressedNDArray(algo, x, x.shape, x.dtype)  # NOOP

    def decompress(self, carr, device=None):
        """The array a CompressedNDArray holds, as an INDArray on
        `device` (the card unless the caller asks for the CPU)."""
        if not hasattr(carr, "algo"):   # a CompressedNDArray of either package
            return carr if isinstance(carr, INDArray) \
                else INDArray(carr, device=device)
        if carr.algo == "GZIP":
            x = np.frombuffer(zlib.decompress(carr.payload),
                              dtype=carr.dtype).reshape(carr.shape)
        elif carr.algo == "FLOAT16":
            x = carr.payload.astype(carr.dtype)
        elif carr.algo == "INT8":
            x = (carr.payload.astype(np.float32)
                 * np.float32(carr.extra)).astype(carr.dtype)
        elif carr.algo == "THRESHOLD":
            n = int(np.prod(carr.shape, dtype=np.int64))
            x = np.zeros(n, dtype=carr.dtype)
            idx = carr.extra["indices"]
            if idx.size:
                x[idx] = (carr.payload.astype(carr.dtype)
                          * carr.dtype.type(carr.extra["threshold"]))
        else:  # NOOP
            x = carr.payload
        return INDArray(np.asarray(x).reshape(carr.shape), device=device)


# ---------------------------------------------------------------------
# post-training int8 weight quantization (dequant-on-use inference)
# ---------------------------------------------------------------------

class QLeaf(NamedTuple):
    """An int8-quantized weight leaf: q int8, scale fp32 broadcast along
    the last (output-channel) axis."""
    q: torch.Tensor
    scale: torch.Tensor


def _tree_map(fn, tree):
    if isinstance(tree, QLeaf):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, QLeaf):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _eligible(a):
    return (isinstance(a, torch.Tensor) and a.is_floating_point()
            and a.ndim >= 2)


def quantize_int8(params):
    """fp weight tree -> the same tree with >=2-D float leaves replaced
    by QLeaf (per-output-channel absmax int8). 1-D leaves (biases, BN
    statistics) stay fp. numpy leaves are taken as CPU tensors."""

    def quant(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.array(a, copy=True))
        if not _eligible(a):
            return a
        x = a.detach().to(torch.float32)
        absmax = torch.amax(torch.abs(x), dim=tuple(range(x.ndim - 1)),
                            keepdim=True)
        scale = torch.where(absmax > 0, absmax / 127.0,
                            torch.ones((), device=x.device))
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return QLeaf(q=q, scale=scale.to(torch.float32))

    return _tree_map(quant, params)


def dequantize(qparams, dtype=torch.float32):
    def dq(leaf):
        if isinstance(leaf, QLeaf):
            return (leaf.q.to(torch.float32) * leaf.scale).to(dtype)
        return leaf

    return _tree_map(dq, qparams)


def quantized_bytes(qparams):
    """(quantized, original-fp32) byte counts for the weight tree."""
    qb = fb = 0
    for leaf in _leaves(qparams):
        if isinstance(leaf, QLeaf):
            qb += leaf.q.numel() + leaf.scale.numel() * 4
            fb += leaf.q.numel() * 4
        elif hasattr(leaf, "numel"):
            qb += leaf.numel() * 4
            fb += leaf.numel() * 4
    return qb, fb


class Int8Inference:
    """Int8 dequant-on-use inference for a trained MultiLayerNetwork or
    ComputationGraph: ``Int8Inference(net).output(x)``. Weights are held
    as int8 + scale and dequantized to the parameter dtype for each
    forward (the network then casts them to its compute dtype as
    usual)."""

    def __init__(self, net):
        net._require_init()
        self._net = net
        self._graph = not hasattr(net, "layers")  # ComputationGraph
        self._qparams = quantize_int8(net._params)

    def output(self, x):
        """Single-input forward. Graphs return their FIRST network output
        (``outputSingle`` semantics); pass a dict of input name -> array
        for a multi-input graph."""
        from deeplearning4j_tpu_torch.nn.multilayer import (
            _out_act, strip_carries,
        )
        from deeplearning4j_tpu_torch.nn.conf import layers as L

        net = self._net
        params = dequantize(self._qparams, net._param_dtype)
        with torch.no_grad():
            if self._graph:
                inputs = x if isinstance(x, dict) \
                    else {net.conf.networkInputs[0]: x}
                acts, _, _ = net._run_graph(params,
                                            strip_carries(net._states),
                                            inputs, False, None, None)
                return INDArray(acts[net.conf.networkOutputs[0]])
            h, _ = net._run_layers(params, net._states, x, False, None)
            last = net.layers[-1]
            return INDArray(_out_act(last, h)
                            if isinstance(last, L.BaseOutputLayer) else h)

    def memoryRatio(self):
        qb, fb = quantized_bytes(self._qparams)
        return qb / max(fb, 1)
