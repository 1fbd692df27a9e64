from mst_torch.audio.synth import render_midi, render_notes, write_wav  # noqa: F401
from mst_torch.audio.spectral import (  # noqa: F401
    stft, mel_filterbank, mel_spectrogram, log_mel, spectral_similarity,
    spectral_similarity_midi,
)
# mp3 decode (system libmpg123 via ctypes) is imported lazily by callers:
# `from mst_torch.audio import mp3` — keeping this package import free of
# ctypes library probing.
