"""The variational autoencoder layer.

The counterpart of ``deeplearning4j_tpu/nn/conf/variational.py``
(reference: conf.layers.variational.VariationalAutoencoder with the
Gaussian and Bernoulli reconstruction distributions; Kingma & Welling
2014). It trains by layerwise ``pretrain`` against the negative ELBO
(``pretrain_loss``) and serves as a deterministic encoder, the mean of
q(z|x), inside a supervised stack.

The encoder and decoder are MLP stacks inside the one layer. The
reference nests their params as lists (``{"enc": [{"W", "b"}, ...]}``);
the port's layer params are one flat dict with dotted names
(``"enc.0.W"``), which the network's carry nests back. The
reparameterisation noise comes from ``draw_eps`` (sample i from the
step's key folded with i, as the reference folds its key), so a test can
inject the reference's draws.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import weights as _winit
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import FeedForwardLayer

__all__ = ["VariationalAutoencoder"]

_LOG2PI = math.log(2.0 * math.pi)


def _bernoulli_nll(logits, x):
    """-log p(x | logits), summed over the features."""
    return (torch.clamp(logits, min=0) - logits * x
            + torch.log1p(torch.exp(-logits.abs()))).sum(-1)


def _gaussian_nll(x, mean, logstd):
    return 0.5 * ((x - mean) * torch.exp(-logstd)).square().add(
        2.0 * logstd + _LOG2PI).sum(-1)


class VariationalAutoencoder(FeedForwardLayer):
    """nOut is the latent size; encoderLayerSizes / decoderLayerSizes the
    hidden widths (the reference builder's names)."""

    def __init__(self, encoderLayerSizes=(100,), decoderLayerSizes=(100,),
                 pzxActivationFunction="identity",
                 reconstructionDistribution="gaussian", numSamples=1, **kw):
        super().__init__(**kw)
        self.encoderLayerSizes = tuple(int(s) for s in encoderLayerSizes)
        self.decoderLayerSizes = tuple(int(s) for s in decoderLayerSizes)
        self.pzxActivationFunction = pzxActivationFunction
        rd = str(reconstructionDistribution).lower()
        if rd not in ("gaussian", "bernoulli"):
            raise ValueError("reconstructionDistribution must be 'gaussian' "
                             "or 'bernoulli'")
        self.reconstructionDistribution = rd
        self.numSamples = int(numSamples)
        self.pretrainable = True

    def getOutputType(self, inputType):
        return InputType.feedForward(self.nOut)

    # the heads' biases ("pZXMeanB", "pXZB", ...) are biases too: l2
    # leaves them and l2Bias takes them (the reference's regularization
    # cannot walk the VAE's nested params)
    def _is_weight(self, name):
        return super()._is_weight(name) and not name.endswith("B")

    def _is_bias(self, name):
        return super()._is_bias(name) or name.endswith("B")

    def _dense(self, gen, a, b, dtype, device):
        return _winit.init(gen, self.weightInit, (a, b), a, b, dtype, device,
                           self.distribution)

    def initialize(self, gen, inputType, dtype, device):
        self.inferNIn(inputType)
        nZ = self.nOut
        out_dim = 2 * self.nIn if self.reconstructionDistribution == \
            "gaussian" else self.nIn
        params = {}
        for part, sizes in (("enc", (self.nIn,) + self.encoderLayerSizes),
                            ("dec", (nZ,) + self.decoderLayerSizes)):
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
                params[f"{part}.{i}.W"] = self._dense(gen, a, b, dtype,
                                                      device)
                params[f"{part}.{i}.b"] = torch.full(
                    (b,), float(self.biasInit), dtype=dtype, device=device)
        eh = self.encoderLayerSizes[-1] if self.encoderLayerSizes \
            else self.nIn
        dh = self.decoderLayerSizes[-1] if self.decoderLayerSizes else nZ
        zeros = dict(dtype=dtype, device=device)
        params.update({
            "pZXMeanW": self._dense(gen, eh, nZ, dtype, device),
            "pZXMeanB": torch.zeros((nZ,), **zeros),
            "pZXLogStdW": self._dense(gen, eh, nZ, dtype, device),
            "pZXLogStdB": torch.zeros((nZ,), **zeros),
            "pXZW": self._dense(gen, dh, out_dim, dtype, device),
            "pXZB": torch.zeros((out_dim,), **zeros)})
        return params, {}

    # ------------------------------------------------------------------
    def _mlp(self, params, part, n, x):
        act = _act.get(self.activation)
        for i in range(n):
            x = act(x @ params[f"{part}.{i}.W"] + params[f"{part}.{i}.b"])
        return x

    def encode(self, params, x):
        """q(z|x) -> (mean, logstd), each [B, nZ]."""
        h = self._mlp(params, "enc", len(self.encoderLayerSizes), x)
        mean = _act.get(self.pzxActivationFunction)(
            h @ params["pZXMeanW"] + params["pZXMeanB"])
        return mean, h @ params["pZXLogStdW"] + params["pZXLogStdB"]

    def decode(self, params, z):
        """p(x|z)'s parameters: (mean, logstd) for a Gaussian, logits for
        a Bernoulli."""
        h = self._mlp(params, "dec", len(self.decoderLayerSizes), z)
        out = h @ params["pXZW"] + params["pXZB"]
        if self.reconstructionDistribution == "gaussian":
            return out[:, :self.nIn], out[:, self.nIn:]
        return out

    def _nll(self, params, x, z):
        out = self.decode(params, z)
        if self.reconstructionDistribution == "gaussian":
            return _gaussian_nll(x, *out)
        return _bernoulli_nll(out, x)

    def forward(self, params, state, x, train, key, mask=None):
        mean, _ = self.encode(params, self._dropout_input(x, train, key))
        return mean, state

    def draw_eps(self, key, shape, device, dtype, n):
        """n standard-normal draws of `shape`, draw i from `key` folded
        with i."""
        return [torch.randn(shape, generator=key.fold(i).generator(device),
                            device=device).to(dtype) for i in range(n)]

    # ------------------------------------------------------------------
    def pretrain_loss(self, params, x, key):
        """The negative ELBO, a mean over the batch: what ``pretrain``
        minimises (reference: ``pretrain_loss``)."""
        mean, logstd = self.encode(params, x)
        kl = 0.5 * (mean.square() + torch.exp(2.0 * logstd) - 1.0
                    - 2.0 * logstd).sum(-1)
        recon = 0.0
        for eps in self.draw_eps(key, mean.shape, mean.device, mean.dtype,
                                 self.numSamples):
            z = mean + torch.exp(logstd) * eps
            recon = recon + self._nll(params, x, z) / self.numSamples
        return (recon + kl).mean()

    def reconstructionLogProbability(self, params, x, numSamples=5,
                                     key=None):
        """An importance-weighted estimate of log p(x) for each example
        (reference: ``reconstructionLogProbability``): ``logsumexp_k[log
        p(x|z_k) + log p(z_k) - log q(z_k|x)] - log K`` with z_k from
        q(z|x). Returns [B]."""
        if key is None:
            from deeplearning4j_tpu_torch.nn.conf.dropout import StepKey

            key = StepKey(0)
        mean, logstd = self.encode(params, x)
        lw = []
        for eps in self.draw_eps(key, mean.shape, mean.device, mean.dtype,
                                 int(numSamples)):
            z = mean + torch.exp(logstd) * eps
            log_qzx = -0.5 * (eps.square() + 2.0 * logstd + _LOG2PI).sum(-1)
            log_pz = -0.5 * (z.square() + _LOG2PI).sum(-1)
            lw.append(-self._nll(params, x, z) + log_pz - log_qzx)
        return torch.logsumexp(torch.stack(lw), dim=0) - math.log(
            float(numSamples))

    def reconstructionProbability(self, params, x, numSamples=5, key=None):
        return torch.exp(self.reconstructionLogProbability(
            params, x, numSamples, key))

    def _mean_out(self, out):
        return out[0] if self.reconstructionDistribution == "gaussian" \
            else torch.sigmoid(out)

    def reconstruct(self, params, x):
        return self._mean_out(self.decode(params, self.encode(params, x)[0]))

    def generate(self, params, z):
        return self._mean_out(self.decode(params, z))
