"""Port parity for the attention layers (deeplearning4j_tpu_torch/nn/conf/
attention.py) against the JAX reference (nn/conf/attention.py), through
each package's ComputationGraph.

Mirrors tests/test_attention.py's TestShapes, TestMasking and
TestBlockwiseParity (built as graphs: the port's ``list()`` waits for
the LeNet slice), then holds each of the four attention layers' output,
loss and every parameter's gradient to the reference's with the
reference's initial parameters carried across. On the CPU the port's
unmasked attention runs the flash kernels' plain versions; the
reference's runs its fused CPU route. Inputs are explicit float32.

Tolerances: output max abs 1e-6 (O(1) softmax outputs), loss rel 1e-5,
each gradient rel L2 1e-4 — both sides compute in f32 and differ only in
the order of their sums; the reference test's own 2e-5 for the
blockwise-vs-fused and masking checks.
"""

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.nn as J
import deeplearning4j_tpu_torch.nn as P
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)


def graph(M, layer, input_types, head=True, out=None, seed=1):
    """in(s) -> layer -> [avg pool ->] output head, through package M's
    builders."""
    names = [f"in{i}" for i in range(len(input_types))]
    b = (M.NeuralNetConfiguration.Builder().seed(seed).updater(M.Sgd(0.1))
         .graphBuilder().addInputs(*names))
    b = b.addVertex("attn", layer, *names)
    last = "attn"
    if head:
        b = b.addLayer("gp", M.GlobalPoolingLayer(poolingType="avg"), "attn")
        last = "gp"
    b = b.addLayer("out", out or M.OutputLayer(nOut=3, activation="softmax"),
                   last)
    return b.setOutputs("out").setInputTypes(*input_types).build()


def port_net(layer, input_types, **kw):
    return P.ComputationGraph(graph(P, layer, input_types, **kw),
                              device="cpu").init()


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


class TestShapes:
    def test_self_attention_shape(self):
        net = port_net(P.SelfAttentionLayer(nOut=8, nHeads=2),
                       [P.InputType.recurrent(4, 6)])
        x = _x(5, 4, 6)
        assert net.output(x).shape() == (5, 3)
        assert net.feedForward(x)["attn"].shape() == (5, 8, 6)

    def test_self_attention_no_projection(self):
        net = port_net(P.SelfAttentionLayer(projectInput=False),
                       [P.InputType.recurrent(4, 6)],
                       out=P.OutputLayer(nOut=2, activation="softmax"))
        assert net._params["attn"] == {}
        assert net.feedForward(_x(5, 4, 6))["attn"].shape() == (5, 4, 6)

    def test_no_projection_multi_head_rejected(self):
        conf = graph(P, P.SelfAttentionLayer(projectInput=False, nHeads=2),
                     [P.InputType.recurrent(4, 6)])
        with pytest.raises(ValueError, match="projectInput"):
            P.ComputationGraph(conf, device="cpu").init()

    def test_learned_self_attention_pools_to_nqueries(self):
        net = port_net(P.LearnedSelfAttentionLayer(nOut=8, nHeads=2,
                                                   nQueries=3),
                       [P.InputType.recurrent(4, 10)])
        acts = net.feedForward(_x(5, 4, 10))
        assert acts["attn"].shape() == (5, 8, 3)

    def test_recurrent_attention_shape_and_carry(self):
        net = port_net(P.RecurrentAttentionLayer(nOut=8, nHeads=2),
                       [P.InputType.recurrent(4, 6)], head=False,
                       out=P.RnnOutputLayer(nOut=2, activation="softmax"))
        assert net.output(_x(5, 4, 6)).shape() == (5, 2, 6)

    def test_attention_vertex_cross_attention_shapes(self):
        net = port_net(P.AttentionVertex(nOut=8, nHeads=2),
                       [P.InputType.recurrent(4, 5),
                        P.InputType.recurrent(6, 9)])
        out = net.output([_x(2, 4, 5), _x(2, 6, 9, seed=1)])
        assert out.shape() == (2, 3)


class TestMasking:
    def test_masked_keys_are_ignored(self):
        """Scores at masked key positions must not affect the output, and
        masked query positions are zeroed."""
        net = port_net(P.SelfAttentionLayer(nOut=6, nHeads=1),
                       [P.InputType.recurrent(4, 8)], head=False,
                       out=P.RnnOutputLayer(nOut=2, activation="softmax"))
        layer = net.conf.nodes["attn"].payload
        x = _x(3, 4, 8)
        x2 = x.copy()
        x2[:, :, 5:] = 99.0  # garbage in the masked region
        mask = np.ones((3, 8), np.float32)
        mask[:, 5:] = 0
        p, m = net._params["attn"], torch.from_numpy(mask)
        with torch.no_grad():
            h1, _ = layer.forward(p, {}, torch.from_numpy(x), False, None, m)
            h2, _ = layer.forward(p, {}, torch.from_numpy(x2), False, None, m)
        np.testing.assert_allclose(h1[:, :, :5].numpy(), h2[:, :, :5].numpy(),
                                   atol=1e-5)
        assert torch.all(h1[:, :, 5:] == 0)


class TestBlockwiseParity:
    def test_blockwise_equals_fused_in_layer(self):
        net = port_net(P.SelfAttentionLayer(nOut=8, nHeads=2),
                       [P.InputType.recurrent(4, 16)], head=False, seed=5,
                       out=P.RnnOutputLayer(nOut=2, activation="softmax"))
        layer = net.conf.nodes["attn"].payload
        x = torch.from_numpy(_x(2, 4, 16))
        p = net._params["attn"]
        with torch.no_grad():
            h_flash, _ = layer.forward(p, {}, x, False, None)
            layer.blockSize = 4
            h_block, _ = layer.forward(p, {}, x, False, None)
        np.testing.assert_allclose(h_flash.numpy(), h_block.numpy(),
                                   rtol=2e-5, atol=2e-5)


LAYERS = {
    "self": (lambda M: M.SelfAttentionLayer(nOut=6, nHeads=2),
             [(4, 5)]),
    "learned": (lambda M: M.LearnedSelfAttentionLayer(nOut=6, nHeads=2,
                                                      nQueries=2),
                [(4, 5)]),
    "recurrent": (lambda M: M.RecurrentAttentionLayer(nOut=4, nHeads=1),
                  [(4, 5)]),
    "vertex-2": (lambda M: M.AttentionVertex(nOut=8, nHeads=2),
                 [(4, 5), (6, 9)]),
    "vertex-3": (lambda M: M.AttentionVertex(nOut=8, nHeads=2),
                 [(4, 5), (6, 9), (6, 9)]),
}


@pytest.mark.parametrize("kind", list(LAYERS))
def test_layer_matches_reference(kind):
    """Output, loss and every gradient of the layer in a graph, with the
    reference's parameters carried across."""
    make, dims = LAYERS[kind]
    jn = J.ComputationGraph(graph(
        J, make(J), [J.InputType.recurrent(f, t) for f, t in dims],
        seed=3)).init()
    pn = P.ComputationGraph(graph(
        P, make(P), [P.InputType.recurrent(f, t) for f, t in dims],
        seed=3), device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params))
    xs = [_x(4, f, t, seed=i) for i, (f, t) in enumerate(dims)]
    y = np.eye(3, dtype=np.float32)[[0, 2, 1, 2]]
    feats = xs if len(xs) > 1 else xs[0]
    tfa.reset_launches()
    pg, ps = pn.computeGradientAndScore(feats, y)
    jg, js = jn.computeGradientAndScore(feats, y)
    if kind in ("self", "learned", "vertex-2"):
        # the projected layers' attention went through FlashAttentionFn
        assert tfa.flash_fwd_plain.launches == 1
        assert tfa.flash_bwd_dq_plain.launches == 1
    assert abs(ps - js) <= 1e-5 * abs(js)
    for n in jg:
        for k in jg[n]:
            want = np.asarray(jg[n][k], np.float64)
            got = pg[n][k].double().numpy()
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 1e-4, (kind, n, k, rel)
    out = pn.output(*xs)
    ref = np.asarray(jn.output(*xs).toNumpy())
    np.testing.assert_allclose(out.toNumpy(), ref, rtol=0, atol=1e-6)


GN_MODES = ["clip_elementwise", "clip_l2_per_layer", "clip_l2_per_param_type",
            "renormalize_l2_per_layer", "renormalize_l2_per_param_type"]


@pytest.mark.parametrize("mode", GN_MODES)
def test_regularization_and_gradient_normalization_match(mode):
    """l1/l2/weight-decay penalties in the loss and each gradient
    normalization mode in the SGD step, against the reference: loss rel
    1e-5 and params after one step within 1e-5 of each tensor's
    max-abs."""
    def conf(M):
        return (M.NeuralNetConfiguration.Builder().seed(2)
                .updater(M.Sgd(0.1)).l1(1e-3).l2(1e-2).weightDecay(1e-3)
                .gradientNormalization(mode)
                .gradientNormalizationThreshold(0.05).graphBuilder()
                .addInputs("in")
                .addLayer("attn", M.SelfAttentionLayer(nOut=6, nHeads=2),
                          "in")
                .addLayer("gp", M.GlobalPoolingLayer(poolingType="avg"),
                          "attn")
                .addLayer("out", M.OutputLayer(nOut=3, activation="softmax"),
                          "gp")
                .setOutputs("out").setInputTypes(M.InputType.recurrent(4, 5))
                .build())

    jn = J.ComputationGraph(conf(J)).init()
    pn = P.ComputationGraph(conf(P), device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params))
    x = _x(4, 4, 5)
    y = np.eye(3, dtype=np.float32)[[0, 2, 1, 2]]
    _, js = jn.computeGradientAndScore(x, y)
    _, ps = pn.computeGradientAndScore(x, y)
    assert abs(ps - js) <= 1e-5 * abs(js)
    jn.fit(x, y)
    pn.fit(x, y)
    for n, p in jn._params.items():
        for k, a in p.items():
            want = np.asarray(a, np.float64)
            got = pn._params[n][k].detach().double().numpy()
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), \
                (mode, n, k)


def test_feature_mask_propagates_through_the_graph():
    """A [B, T] feature mask on the input reaches the attention layer as
    its key mask and the pooling layer as its time mask, as in the
    reference's _run_graph: same output on both sides."""
    make = lambda M: M.SelfAttentionLayer(nOut=6, nHeads=2)
    jn = J.ComputationGraph(graph(J, make(J), [J.InputType.recurrent(4, 8)],
                                  seed=4)).init()
    pn = P.ComputationGraph(graph(P, make(P), [P.InputType.recurrent(4, 8)],
                                  seed=4), device="cpu").init()
    pn.load_reference_params(jax.tree.map(np.asarray, jn._params))
    x = _x(3, 4, 8)
    mask = np.ones((3, 8), np.float32)
    mask[0, 5:] = 0
    mask[2, 2:] = 0
    jacts, _, _ = jn._run_graph(jn._params, jn._states, {"in0": x}, False,
                                None, {"in0": jax.numpy.asarray(mask)})
    with torch.no_grad():
        pacts, _, _ = pn._run_graph(pn._params, pn._states,
                                    {"in0": torch.from_numpy(x)}, False,
                                    None, {"in0": torch.from_numpy(mask)})
    for name in ("attn", "gp", "out"):
        np.testing.assert_allclose(pacts[name].numpy(),
                                   np.asarray(jacts[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert torch.all(pacts["attn"][0, :, 5:] == 0)
