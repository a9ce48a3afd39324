"""Audio feature extraction — the DataVec audio path.

The counterpart of ``deeplearning4j_tpu/data/audio.py`` (reference:
datavec-data-audio WavFileRecordReader and the spectrogram features
upstream computes with musicg/JTransforms on the JVM host). As the
reference runs the front end as one program on its device, the port runs
it as torch ops on the transform's ``device`` (the card unless the
caller passes ``device="cpu"``; host waveforms, as ``WavFileRecordReader``
gives them, are copied there): framing, the periodic Hann window,
``torch.fft.rfft``, and the mel filterbank and DCT-II as products with
the reference's matrices (``mel_filterbank``, ``_dct2``).

Shapes: waveforms [B, T] float -> Spectrogram [B, frames, bins] ->
MelSpectrogram [B, frames, numMel] -> MFCC [B, frames, numCoeffs].
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.records import RecordReader
from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["SpectrogramTransform", "MelSpectrogramTransform",
           "MFCCTransform", "WavFileRecordReader", "mel_filterbank"]


def _hann(n, device):
    # periodic Hann, the STFT convention (computed as the reference does)
    k = torch.arange(n, device=device, dtype=torch.float32)
    return 0.5 - 0.5 * torch.cos(2.0 * torch.pi * k / n)


def _frame(x, frame_length, frame_step):
    """[B, T] -> [B, frames, frame_length]; the trailing partial frame is
    dropped (static shapes)."""
    B, T = x.shape
    n = 1 + (T - frame_length) // frame_step
    if n < 1:
        raise ValueError(
            f"signal length {T} shorter than frame_length {frame_length}")
    return x.unfold(1, frame_length, frame_step)[:, :n]


def mel_filterbank(num_mel, fft_length, sample_rate, fmin=0.0, fmax=None):
    """[bins, num_mel] triangular mel filterbank (HTK mel scale, the
    convention upstream's speech examples use)."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    if not (0 <= fmin < fmax <= sample_rate / 2.0):
        raise ValueError(f"need 0 <= fmin < fmax <= nyquist, got "
                         f"[{fmin}, {fmax}] at rate {sample_rate}")

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    bins = fft_length // 2 + 1
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mel + 2)
    hz_pts = mel_to_hz(mel_pts)
    bin_freqs = np.arange(bins) * sample_rate / fft_length
    fb = np.zeros((bins, num_mel), np.float32)
    for m in range(num_mel):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - bin_freqs) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    dead = np.flatnonzero(fb.max(0) == 0.0)
    if dead.size:
        raise ValueError(
            f"mel filters {dead.tolist()} are all-zero: triangles narrower "
            f"than the FFT bin spacing ({sample_rate / fft_length:.1f} Hz). "
            "Reduce num_mel or increase fft_length")
    return fb


def _dct2(n_in, n_out):
    """[n_in, n_out] orthonormal DCT-II matrix (scipy.fft.dct norm='ortho')."""
    k = np.arange(n_out)[None, :]
    i = np.arange(n_in)[:, None]
    m = np.cos(np.pi * k * (2 * i + 1) / (2.0 * n_in))
    m *= np.sqrt(2.0 / n_in)
    m[:, 0] *= np.sqrt(0.5)
    return m.astype(np.float32)


class SpectrogramTransform:
    """|STFT|^2 power spectrogram (reference: the musicg spectrogram
    upstream's audio readers produce), computed in float32 on
    ``device`` (the card unless ``"cpu"`` is asked for)."""

    def __init__(self, frameLength=400, frameStep=160, fftLength=None,
                 device=None):
        self.frameLength = int(frameLength)
        self.frameStep = int(frameStep)
        self.fftLength = int(fftLength or self.frameLength)
        if self.fftLength < self.frameLength:
            raise ValueError("fftLength must be >= frameLength")
        self.device = resolve_device(device)

    def _compute(self, x):
        frames = _frame(x, self.frameLength, self.frameStep)
        frames = frames * _hann(self.frameLength, x.device)
        spec = torch.fft.rfft(frames, n=self.fftLength)
        return spec.abs() ** 2

    def apply(self, waveforms):
        x = waveforms if isinstance(waveforms, torch.Tensor) else \
            torch.from_numpy(np.asarray(waveforms, np.float32))
        x = x.to(self.device, torch.float32)
        if x.dim() != 2:
            raise ValueError(f"waveforms must be [B, T], got "
                             f"{tuple(x.shape)}")
        return self._compute(x)

    def __call__(self, waveforms):
        return self.apply(waveforms)


class MelSpectrogramTransform(SpectrogramTransform):
    def __init__(self, numMel=40, sampleRate=16000, fmin=0.0, fmax=None,
                 logScale=True, **kw):
        super().__init__(**kw)
        self.numMel = int(numMel)
        self.sampleRate = int(sampleRate)
        self.logScale = bool(logScale)
        self._fb = torch.from_numpy(mel_filterbank(
            self.numMel, self.fftLength, self.sampleRate, fmin,
            fmax)).to(self.device)

    def _compute(self, x):
        power = super()._compute(x)
        mel = power @ self._fb   # [B, frames, numMel]
        if self.logScale:
            mel = torch.log(mel + 1e-6)
        return mel


class MFCCTransform(MelSpectrogramTransform):
    def __init__(self, numCoeffs=13, **kw):
        kw.setdefault("logScale", True)
        super().__init__(**kw)
        if not self.logScale:
            raise ValueError("MFCC requires logScale=True (DCT of log-mel)")
        self.numCoeffs = int(numCoeffs)
        if self.numCoeffs > self.numMel:
            raise ValueError(
                f"numCoeffs {self.numCoeffs} > numMel {self.numMel}")
        self._dct = torch.from_numpy(_dct2(self.numMel,
                                           self.numCoeffs)).to(self.device)

    def _compute(self, x):
        return super()._compute(x) @ self._dct


class WavFileRecordReader(RecordReader):
    """PCM .wav files -> float waveforms in [-1, 1] (reference:
    datavec-data-audio WavFileRecordReader). Directory layout and record
    shape mirror ImageRecordReader: ``root/<label>/<file>.wav`` ->
    ``[waveform float array, labelIndex]`` with getLabels()/numLabels(),
    so RecordReaderDataSetIterator consumes it directly. Stereo is
    averaged to mono; `length` pads/truncates to a fixed shape. All files
    must share one sample rate (validated at initialize; exposed as
    ``.sampleRate``)."""

    arrayRecords = True  # record = [array, labelIndex]

    def __init__(self, length=None):
        self.length = None if length is None else int(length)
        self.sampleRate = None
        self._files = []
        self._label_names = []
        self._i = 0

    def initialize(self, root):
        import wave
        from pathlib import Path

        root = Path(root)
        classes = sorted(d.name for d in root.iterdir() if d.is_dir())
        self._label_names = classes
        self._files = []
        rates = {}
        for ci, cname in enumerate(classes):
            for f in sorted((root / cname).iterdir()):
                if f.suffix.lower() == ".wav" and f.is_file():
                    self._files.append((f, ci))
                    with wave.open(str(f), "rb") as w:
                        rates.setdefault(w.getframerate(), f)
        if not self._files:
            raise ValueError(f"no .wav files under {root} "
                             "(expected root/<label>/<file>.wav)")
        if len(rates) > 1:
            raise ValueError(
                f"mixed sample rates {sorted(rates)} under {root}; "
                "resample to one rate first")
        self.sampleRate = next(iter(rates))
        self._i = 0
        return self

    def getLabels(self):
        return list(self._label_names)

    def numLabels(self) -> int:
        return len(self._label_names)

    def hasNext(self):
        return self._i < len(self._files)

    def reset(self):
        self._i = 0

    @staticmethod
    def _read(path):
        import wave

        with wave.open(str(path), "rb") as w:
            nch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(w.getnframes())
            rate = w.getframerate()
        if width == 2:
            data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif width == 1:  # unsigned 8-bit PCM
            data = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported WAV sample width {width} bytes")
        if nch > 1:
            data = data.reshape(-1, nch).mean(1)
        return data, rate

    def next(self):
        path, label = self._files[self._i]
        self._i += 1
        data, _ = self._read(path)
        if self.length is not None:
            if len(data) >= self.length:
                data = data[:self.length]
            else:
                data = np.pad(data, (0, self.length - len(data)))
        return [data, label]
