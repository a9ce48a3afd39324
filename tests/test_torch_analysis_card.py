"""The static analysis tier's card checks (``cuda`` marker).

- The token clamp: a decode step fed an out-of-range token (the value a
  ``corrupt`` fault at ``sequence.step`` writes) gathers the clamped row
  on the card with no device assert, and the context survives
  (``torch.cuda.synchronize()`` returns); its logits equal the step fed
  the clamped token.
- PAR06 against the card, cuDNN's convolutions on: the predicted
  high-water mark of a small CNN's eager fit step lies within the
  smoke's band (chip_smoke.PAR06_BAND: never more than 10 % under
  ``torch.cuda.max_memory_allocated``) at PyTorch's default cuDNN
  settings and at the smoke's (deterministic, TF32 off), where PAR06
  counts the f32 convolutions' cuDNN workspaces.
- The shape pass allocates nothing on the card.

This file imports neither jax nor the reference package:
    python3 -m pytest --noconftest -q tests/test_torch_analysis_card.py
Without a card every test skips.
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

#: chip_smoke.PAR06_BAND (predicted / measured)
BAND = (0.90, 1.30)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 and the caching allocator's "
                    "statistics exist only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


@pytest.mark.parametrize("bad", [2 ** 31 - 1, -1, -(2 ** 31)])
def test_out_of_range_token_decodes_without_a_device_assert(card, bad):
    from deeplearning4j_tpu_torch.nn.transformer import CausalTransformerLM

    lm = CausalTransformerLM(vocab=64, d_model=64, n_heads=2, n_layers=2,
                             max_context=64, page_size=16, seed=1,
                             device=card)
    V = lm.vocab
    pools = [torch.zeros((2, 6, 16, 2, 32), device=card,
                         dtype=lm.emb.dtype) for _ in range(2)]
    bts = torch.tensor([[1, 0, 0, 0], [2, 0, 0, 0]], dtype=torch.int32,
                       device=card)
    sls = torch.tensor([3, 3], dtype=torch.int32, device=card)
    clamped = V - 1 if bad > 0 else (V - 1 if bad == -1 else 0)

    def step(tok):
        k, v = (p.clone() for p in pools)
        toks = torch.tensor([tok, 5], dtype=torch.int32, device=card)
        return lm.decode_paged(toks, k, v, bts, sls)[0]

    got = step(bad)
    torch.cuda.synchronize()
    want = step(clamped)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


#: cuDNN's settings the PAR06 cases run under: PyTorch's defaults, and
#: the smoke's (deterministic, TF32 off)
CUDNN = {"defaults": dict(deterministic=False, allow_tf32=True),
         "deterministic_no_tf32": dict(deterministic=True,
                                       allow_tf32=False)}


@contextlib.contextmanager
def _cudnn(**kw):
    old = {k: getattr(torch.backends.cudnn, k) for k in kw}
    for k, v in kw.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(torch.backends.cudnn, k, v)


def _prediction(B):
    from deeplearning4j_tpu_torch.analysis import validate_plan
    from deeplearning4j_tpu_torch.zoo import SimpleCNN

    conf = SimpleCNN(numClasses=10, inputShape=(3, 64, 64)).conf()
    return validate_plan(conf, {"data": 1}, batchSize=B).plan["memory"]


def _settle(card):
    # the process's one-time library workspaces (cuBLAS's for autograd's
    # device thread, 34 MiB measured on the H100) are not the step's:
    # make them before the measurement starts
    w = torch.ones(8, 8, device=card, requires_grad=True)
    (w @ w).sum().backward()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(card)


def _small_cnn_fit(card, B):
    from deeplearning4j_tpu_torch.zoo import SimpleCNN

    net = SimpleCNN(numClasses=10, inputShape=(3, 64, 64),
                    device=card).init()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((B, 3, 64, 64),
                                    dtype=np.float32)).to(card)
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, B)]).to(card)
    losses = []
    for _ in range(3):
        net.fit(x, y)
        losses.append(net.score())
    torch.cuda.synchronize()
    assert all(np.isfinite(losses)), losses


@pytest.mark.parametrize("setting", sorted(CUDNN))
def test_par06_prediction_within_the_band(card, setting):
    """PAR06 counts the tensors of the step (autograd's saved
    activations, gradients, updater and temporaries), not the process's
    one-time cuBLAS workspaces (made first). At PyTorch's default cuDNN
    settings the convolution workspaces that overlap the step's peak are
    small and none is counted. With TF32 off an f32 convolution's
    workspace is large (scripts/conv_workspace.py), and PAR06 holds one
    of the measured median size while each such call runs: the
    prediction reads the cuDNN settings, so it is made under them."""
    B = 64
    with _cudnn(**CUDNN[setting]):
        pred = _prediction(B)
        _settle(card)
        base = torch.cuda.memory_allocated(card)
        _small_cnn_fit(card, B)
        peak = torch.cuda.max_memory_allocated(card) - base
    ratio = pred["total_bytes"] / peak
    assert BAND[0] <= ratio <= BAND[1], (ratio, pred["total_bytes"], peak)


def test_the_shape_pass_allocates_nothing_on_the_card(card):
    from deeplearning4j_tpu_torch.analysis import validate_model
    from deeplearning4j_tpu_torch.zoo import ResNet50

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    rep = validate_model(ResNet50(numClasses=1000), batchSize=128)
    gc.collect()
    torch.cuda.synchronize()
    assert rep.ok
    assert torch.cuda.memory_allocated(card) == before
