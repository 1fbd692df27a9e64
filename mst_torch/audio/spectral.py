"""STFT / mel-spectrogram / spectral similarity on the device.

The counterpart of mst_tpu/audio/spectral.py:25-99, in torch on an explicit
device (``device=None`` is the GPU and raises without one; pass ``"cpu"``
for the host). Framing is a gather of frame indices, then
``torch.fft.rfft(frames * window)`` and ``(mag * mag) @ fb``: in JAX these
are plain XLA ops, not Pallas kernels. Everything stays fp32, as JAX runs it
with x64 off. Three details keep the port on JAX's numbers:

- the Hann window is the periodic ``0.5 - 0.5 cos(2 pi n / N)``, computed
  in fp32 as JAX computes it, not ``torch.hann_window``;
- the frame gather clamps out-of-range indices as JAX's gather does, so a
  PCM shorter than ``n_fft`` gives one frame padded with its last sample
  (torch indexing would raise);
- the pooled standard deviation is the population one (``correction=0``,
  numpy's and JAX's ``ddof=0``; torch's default is 1).

The similarity score compares log-mel statistics of two renditions; the
audio eval (``transfer.transfer_and_evaluate``) uses it to score styled
output against its composition and its style source.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from mst_torch.audio.synth import SAMPLE_RATE, render_midi
from mst_torch.device import resolve_device

N_FFT = 1024
HOP = 256
N_MELS = 80


def _pcm(pcm, device) -> torch.Tensor:
    """A waveform (numpy array or tensor) as fp32 on the resolved device."""
    return torch.as_tensor(pcm, dtype=torch.float32,
                           device=resolve_device(device))


def hann(n: int, device=None) -> torch.Tensor:
    """Periodic Hann window of length ``n`` in fp32 (spectral.py:25-26)."""
    k = torch.arange(n, dtype=torch.float32, device=resolve_device(device))
    return 0.5 - 0.5 * torch.cos(2 * math.pi * k / n)


def stft(pcm, n_fft: int = N_FFT, hop: int = HOP,
         device=None) -> torch.Tensor:
    """(T,) -> (frames, n_fft//2+1) magnitude spectrogram. Frame indices
    past the end clamp to the last sample, as JAX's gather does."""
    pcm = _pcm(pcm, device)
    n_frames = max(1, (pcm.shape[0] - n_fft) // hop + 1)
    dev = pcm.device
    idx = (torch.arange(n_frames, device=dev)[:, None] * hop
           + torch.arange(n_fft, device=dev)[None, :])
    frames = pcm[idx.clamp(max=pcm.shape[0] - 1)] * hann(n_fft, dev)[None, :]
    return torch.fft.rfft(frames, dim=-1).abs()


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def _mel_filterbank_np(n_mels: int, n_fft: int, sample_rate: int,
                       fmin: float, fmax: float) -> np.ndarray:
    fmax = fmax or sample_rate / 2
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bins = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
    fb = np.zeros((len(bins), n_mels))
    for m in range(n_mels):
        left, center, right = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bins - left) / max(center - left, 1e-9)
        down = (right - bins) / max(right - center, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    fb = fb.astype(np.float32)
    fb.flags.writeable = False
    return fb


def mel_filterbank(n_mels: int = N_MELS, n_fft: int = N_FFT,
                   sample_rate: int = SAMPLE_RATE, fmin: float = 0.0,
                   fmax: float = None, device=None) -> torch.Tensor:
    """(n_fft//2+1, n_mels) triangular filter matrix (Slaney-style layout),
    built on the host in float64 and stored fp32, as mst_tpu builds it."""
    fb = _mel_filterbank_np(n_mels, n_fft, sample_rate, fmin, fmax)
    return torch.tensor(fb, device=resolve_device(device))


def mel_spectrogram(pcm, n_fft: int = N_FFT, hop: int = HOP,
                    n_mels: int = N_MELS, sample_rate: int = SAMPLE_RATE,
                    device=None) -> torch.Tensor:
    """(T,) -> (frames, n_mels) power mel spectrogram."""
    mag = stft(pcm, n_fft=n_fft, hop=hop, device=device)
    fb = mel_filterbank(n_mels, n_fft, sample_rate, device=mag.device)
    return (mag * mag) @ fb


def log_mel(pcm, device=None, **kw) -> torch.Tensor:
    return torch.log(mel_spectrogram(pcm, device=device, **kw) + 1e-8)


def _similarity_stats(mel_a: torch.Tensor, mel_b: torch.Tensor):
    """Cosine similarity of time-pooled log-mel statistics (mean ++ std)."""
    def pooled(m):
        return torch.cat([m.mean(dim=0), m.std(dim=0, correction=0)])
    a, b = pooled(mel_a), pooled(mel_b)
    a = a - a.mean()
    b = b - b.mean()
    denom = torch.linalg.norm(a) * torch.linalg.norm(b) + 1e-8
    return torch.dot(a, b) / denom


def spectral_similarity(pcm_a, pcm_b, device=None, **kw) -> float:
    """[-1, 1] cosine similarity of log-mel statistics of two waveforms."""
    device = resolve_device(device)
    return float(_similarity_stats(log_mel(pcm_a, device=device, **kw),
                                   log_mel(pcm_b, device=device, **kw)))


def spectral_similarity_midi(midi_a, midi_b, device=None) -> float:
    """Render two parsed MIDI files on the host (audio.synth) and score
    their spectral similarity on ``device``."""
    return spectral_similarity(render_midi(midi_a), render_midi(midi_b),
                               device=device)
