"""The port's image augmentation and audio features against the
reference's (``deeplearning4j_tpu/data/{augment,audio}.py``).

Augmentation runs under the reference's draws, replayed into the port
(``applyDrawn``): flips and crops exact, rotation within 1e-5 absolute
(f32 images in [0, 1]; the reference rotates through
``jax.scipy.ndimage.map_coordinates(order=1, mode="constant")``). The
draws themselves differ (Philox vs threefry, a stated deviation): the
port's stream is pinned by its own determinism. Audio: f32 features
within 1e-5 of each output's max-abs; the filterbank, the DCT matrix and
the WAV reader exact. Mirrors ``tests/test_augment.py`` and
``tests/test_audio.py``."""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.data as J
import deeplearning4j_tpu_torch.data as P
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import audio as jaudio
from deeplearning4j_tpu_torch.data import audio as paudio
from deeplearning4j_tpu_torch.nn.conf.dropout import StepKey

torch.set_num_threads(1)


def _images(B=4, C=3, H=12, W=10, seed=0):
    return np.random.RandomState(seed).rand(B, C, H, W).astype(np.float32)


def _ref_draws(transforms, key, B, H, W):
    """The reference's draws for each stage of a pipeline under `key`
    (``PipelineImageTransform.apply``: stage i at fold_in(key, i))."""
    draws = []
    for i, t in enumerate(transforms):
        k = jax.random.fold_in(key, i)
        if isinstance(t, J.FlipImageTransform):
            draws.append(torch.from_numpy(np.asarray(
                jax.random.bernoulli(k, t.p, (B,)))))
        elif isinstance(t, J.RandomCropTransform):
            ky, kx = jax.random.split(k)
            my, mx = H + 2 * t.pad - t.h, W + 2 * t.pad - t.w
            draws.append(tuple(torch.from_numpy(np.asarray(
                jax.random.randint(kk, (B,), 0, m + 1)))
                for kk, m in ((ky, my), (kx, mx))))
            H, W = t.h, t.w
        elif isinstance(t, J.RotateImageTransform):
            draws.append(torch.from_numpy(np.asarray(jax.random.uniform(
                k, (B,), jnp.float32, minval=-t.max_rad, maxval=t.max_rad))))
        else:
            draws.append(None)
    return draws


_PIPES = {
    "flip": lambda D: [D.FlipImageTransform(0.5)],
    "crop": lambda D: [D.RandomCropTransform(10, 8, pad=2)],
    "rotate": lambda D: [D.RotateImageTransform(15)],
    "flip_crop_rotate": lambda D: [D.FlipImageTransform(0.5),
                                   D.RandomCropTransform(12, 10, pad=3),
                                   D.RotateImageTransform(30)],
}


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name", sorted(_PIPES))
def test_augmentation_under_the_reference_draws(name, fmt):
    x = _images(B=6)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    seed, counter = 7, 0
    jpre = J.ImageAugmentationPreProcessor(
        J.PipelineImageTransform(*_PIPES[name](J)), seed=seed,
        dataFormat=fmt)
    want = np.asarray(jpre.preProcess(JDataSet(x, np.zeros((6, 2),
                                                           np.float32)))
                      .getFeatures().toNumpy())
    key = jax.random.fold_in(jax.random.key(seed), counter)
    draws = _ref_draws(jpre.transform.transforms, key, 6, 12, 10)
    ppre = P.ImageAugmentationPreProcessor(
        P.PipelineImageTransform(*_PIPES[name](P)), seed=seed,
        dataFormat=fmt, device="cpu")
    got = ppre.run(torch.from_numpy(x), draws=draws).numpy()
    assert got.shape == want.shape
    if "rotate" in name:
        assert np.abs(got - want).max() <= 1e-5
    else:
        np.testing.assert_array_equal(got, want)


def test_rotation_zero_fill_at_the_edges():
    """A large angle carries corners outside the image: those samples
    are zero, partial edges weigh only their inside corners."""
    x = _images(B=2, H=9, W=9, seed=3)
    jx = jnp.asarray(x.transpose(0, 2, 3, 1))
    angles = np.array([0.7, -1.2], np.float32)
    # the reference's per-image rotation, under the given angles
    from jax.scipy.ndimage import map_coordinates
    H = W = 9
    yy, xx = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing="ij")
    want = []
    for img, a in zip(jx, angles):
        ca, sa = jnp.cos(a), jnp.sin(a)
        sy = 4.0 + (yy - 4.0) * ca - (xx - 4.0) * sa
        sx = 4.0 + (yy - 4.0) * sa + (xx - 4.0) * ca
        want.append(np.stack([np.asarray(map_coordinates(
            img[..., c], [sy, sx], order=1, mode="constant", cval=0.0))
            for c in range(3)], -1))
    got = P.RotateImageTransform(90).applyDrawn(
        torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 3, 1))),
        torch.from_numpy(angles)).numpy()
    assert np.abs(got - np.stack(want)).max() <= 1e-5
    assert (got == 0).any()


def test_resize_matches_the_reference():
    """Half-pixel bilinear, antialiased when shrinking: within 1e-6."""
    x = _images(B=2, H=8, W=6)
    for size in ((16, 12), (5, 4), (4, 3)):
        want = np.asarray(J.ResizeImageTransform(*size).apply(
            None, jnp.asarray(x.transpose(0, 2, 3, 1))))
        got = P.ResizeImageTransform(*size).applyDrawn(
            torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 3, 1))),
            None).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6


def test_stream_is_keyed_by_seed_and_batch_counter():
    """A restarted preprocessor redraws the same stream; the next batch
    draws anew."""
    x = torch.from_numpy(_images(B=8))

    def pre():
        return P.ImageAugmentationPreProcessor(
            P.PipelineImageTransform(*_PIPES["flip_crop_rotate"](P)), seed=5,
            device="cpu")

    a, b = pre(), pre()
    a1, b1 = a.run(x), b.run(x)
    assert torch.equal(a1, b1)
    a2 = a.run(x)
    assert not torch.equal(a1, a2)
    # the second batch's first stage drew from (seed, counter 1), stage 0
    flips = P.FlipImageTransform(0.5).draw(StepKey(5, 1).fold(0), x.shape,
                                           "cpu")
    assert torch.equal(flips, a.lastDraws[0])


def test_preprocessor_on_an_iterator_and_guards():
    x, y = _images(B=8), np.eye(2, dtype=np.float32)[np.arange(8) % 2]
    it = P.DataSetIterator(x, y, 4)
    it.setPreProcessor(P.ImageAugmentationPreProcessor(
        P.PipelineImageTransform(P.FlipImageTransform(1.0)), seed=1,
        device="cpu"))
    ds = it.next()
    np.testing.assert_array_equal(np.asarray(ds.getFeatures()),
                                  x[:4, :, :, ::-1])
    with pytest.raises(ValueError, match="larger than padded"):
        P.RandomCropTransform(20, 20).apply(StepKey(0),
                                            torch.zeros(1, 8, 8, 1))
    with pytest.raises(ValueError, match="4-d"):
        P.ImageAugmentationPreProcessor(P.FlipImageTransform(),
                                        device="cpu").run(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="flip probability"):
        P.FlipImageTransform(1.5)
    with pytest.raises(ValueError, match="dataFormat"):
        P.ImageAugmentationPreProcessor(P.FlipImageTransform(), dataFormat="X")


def test_bf16_images_keep_their_dtype():
    x = torch.from_numpy(_images(B=2, H=40, W=40)).to(torch.bfloat16)
    out = P.ImageAugmentationPreProcessor(
        P.PipelineImageTransform(*_PIPES["flip_crop_rotate"](P)),
        device="cpu").run(x)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3, 12, 10)


def test_preprocess_puts_host_batches_on_its_device():
    """An iterator's host batch goes to the preprocessor's device before
    the transform runs; with no device given, the card (none here:
    refused, no silent CPU run)."""
    x = _images(B=4)
    pre = P.ImageAugmentationPreProcessor(P.FlipImageTransform(1.0),
                                          device="cpu")
    out = pre.preProcess(P.DataSet(x, np.zeros((4, 2), np.float32)))
    f = out.getFeatures()
    assert isinstance(f, torch.Tensor) and f.device == pre.device
    np.testing.assert_array_equal(f.numpy(), x[:, :, :, ::-1])
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.ImageAugmentationPreProcessor(P.FlipImageTransform())


# ------------------------------------------------------------------ audio
def _signal(B=3, T=4000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(T) / 16000.0
    tones = np.sin(2 * np.pi * rng.uniform(200, 3000, (B, 1)) * t)
    return (0.5 * tones + 0.05 * rng.randn(B, T)).astype(np.float32)


_FEATURES = {
    "spectrogram": lambda D, **kw: D.SpectrogramTransform(
        frameLength=256, frameStep=128, **kw),
    "spectrogram_fft512": lambda D, **kw: D.SpectrogramTransform(
        frameLength=400, frameStep=160, fftLength=512, **kw),
    "mel": lambda D, **kw: D.MelSpectrogramTransform(
        numMel=40, frameLength=400, frameStep=160, fftLength=512, **kw),
    "mel_linear": lambda D, **kw: D.MelSpectrogramTransform(
        numMel=20, logScale=False, frameLength=256, frameStep=128, **kw),
    "mfcc": lambda D, **kw: D.MFCCTransform(
        numCoeffs=13, frameLength=400, frameStep=160, fftLength=512, **kw),
}


@pytest.mark.parametrize("name", sorted(_FEATURES))
def test_audio_features_match_the_reference(name):
    x = _signal()
    want = np.asarray(_FEATURES[name](J).apply(x), np.float64)
    got = _FEATURES[name](P, device="cpu").apply(
        torch.from_numpy(x)).double().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_filterbank_and_dct_are_the_reference_matrices():
    for args in ((20, 512, 16000), (40, 512, 16000, 100.0, 7000.0)):
        np.testing.assert_array_equal(paudio.mel_filterbank(*args),
                                      jaudio.mel_filterbank(*args))
    np.testing.assert_array_equal(paudio._dct2(40, 13), jaudio._dct2(40, 13))
    with pytest.raises(ValueError, match="all-zero"):
        paudio.mel_filterbank(128, 64, 16000)


def _write_wav(path, data, rate=16000, width=2, nch=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(nch)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data.tobytes())


def _wav_tree(root):
    rng = np.random.RandomState(4)
    for ci, cls in enumerate(("no", "yes")):
        d = root / cls
        d.mkdir(parents=True)
        for i in range(3):
            n = 1200 + 100 * i
            _write_wav(d / f"{i}.wav",
                       (rng.randn(n) * 8000).astype("<i2"))
        _write_wav(d / "st.wav", (rng.randn(900, 2) * 8000).astype("<i2"),
                   nch=2)
        _write_wav(d / "u8.wav", rng.randint(0, 255, 700).astype("u1"),
                   width=1)
    return root


def test_wav_reader_matches_the_reference(tmp_path):
    root = _wav_tree(tmp_path / "wav")

    def run(D):
        rr = D.WavFileRecordReader(length=1000).initialize(root)
        recs = [rr.next() for _ in range(10)]
        rr.reset()
        it = D.RecordReaderDataSetIterator(rr, batchSize=4)
        b = it.next()
        return [rr.getLabels(), rr.sampleRate,
                [(np.asarray(a), l) for a, l in recs],
                np.asarray(b.getFeatures().toNumpy()
                           if hasattr(b.getFeatures(), "toNumpy")
                           else b.getFeatures()),
                np.asarray(b.getLabels().toNumpy()
                           if hasattr(b.getLabels(), "toNumpy")
                           else b.getLabels())]

    got, want = run(P), run(J)
    assert got[:2] == want[:2]
    for (a, la), (b, lb) in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)
        assert la == lb
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])


def test_features_of_host_waveforms_on_the_transform_device(tmp_path):
    """The reader's numpy clips go to the transform's device; with no
    device given, the card (none here: refused)."""
    root = _wav_tree(tmp_path / "wav")
    rr = P.WavFileRecordReader(length=1000).initialize(root)
    clips = np.stack([rr.next()[0] for _ in range(4)])
    m = P.MFCCTransform(numCoeffs=13, frameLength=400, frameStep=160,
                        fftLength=512, device="cpu")
    got = m.apply(clips)
    assert got.device == m.device and got.dtype == torch.float32
    want = np.asarray(J.MFCCTransform(numCoeffs=13, frameLength=400,
                                      frameStep=160, fftLength=512)
                      .apply(clips), np.float64)
    assert np.abs(got.double().numpy() - want).max() <= \
        1e-5 * np.abs(want).max()
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.MFCCTransform()


def test_audio_guards_as_the_reference(tmp_path):
    with pytest.raises(ValueError, match="fftLength"):
        P.SpectrogramTransform(frameLength=256, fftLength=128, device="cpu")
    with pytest.raises(ValueError, match="shorter"):
        P.SpectrogramTransform(frameLength=256, device="cpu").apply(
            np.zeros((1, 100), "float32"))
    with pytest.raises(ValueError, match="B, T"):
        P.SpectrogramTransform(device="cpu").apply(np.zeros(1000, "float32"))
    with pytest.raises(ValueError, match="logScale"):
        P.MFCCTransform(logScale=False, device="cpu")
    with pytest.raises(ValueError, match="numCoeffs"):
        P.MFCCTransform(numCoeffs=50, numMel=40, device="cpu")
    with pytest.raises(ValueError, match="no .wav"):
        P.WavFileRecordReader().initialize(tmp_path)
    d = tmp_path / "a"
    d.mkdir()
    _write_wav(d / "1.wav", np.zeros(100, "<i2"), rate=16000)
    _write_wav(d / "2.wav", np.zeros(100, "<i2"), rate=8000)
    with pytest.raises(ValueError, match="mixed sample rates"):
        P.WavFileRecordReader().initialize(tmp_path)
