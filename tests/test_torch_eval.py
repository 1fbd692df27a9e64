"""The port's audio-eval path and host tools against mst_tpu, on the CPU.

Tolerances, each stated where it is used:

- ``stft`` and ``mel_spectrogram``: rtol 1e-5 (fp32 FFTs of two libraries
  and sums in other orders); ``log_mel``: atol 1e-5, the log of that;
  ``hann``: atol 1e-7 (one fp32 ulp of cos near 1); ``mel_filterbank``:
  exact (the same float64 numpy, stored fp32);
- ``spectral_similarity``: 1e-5 absolute. It also covers the ``ddof=0``
  standard deviation: torch's default ``correction=1`` gives NaN on the
  one-frame PCMs and moves the score by 5e-3 at 1,300 samples and 8e-5 at
  30,000;
- synthesis, ``analysis``, ``utils`` and the corpus-stats CSV: exact;
- ``transfer_and_evaluate``: the same keys and ``None`` pattern as
  mst_tpu's, and each score within 1e-5 of mst_tpu's
  ``spectral_similarity_midi`` on the port's own files (the files may
  differ from mst_tpu's in fp32-boundary cells, tests/test_torch_transfer).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mst_tpu import analysis as janalysis
from mst_tpu import audio as jaudio
from mst_tpu import transfer as jt
from mst_tpu import utils as jutils
from mst_tpu.audio import mp3 as jmp3
from mst_tpu.io import load_midi_from_file as j_load
from mst_tpu.ops import events as jevents
from mst_torch import analysis as tanalysis
from mst_torch import audio as taudio
from mst_torch import transfer as tt
from mst_torch import utils as tutils
from mst_torch.audio import mp3 as tmp3
from mst_torch.audio import spectral
from mst_torch.io import load_midi_from_file as t_load
from mst_torch.ops import events as tevents
from tests.test_torch_transfer import _write_songs, bundles  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "mst_torch", "assets", "smoke")
SMOKE_SONGS = sorted(n[:-4] for n in os.listdir(SMOKE) if n.endswith(".mid"))
SIM_ATOL = 1e-5


def _pcm_pair(n, seed):
    """Noise and an amplitude-modulated sine of ``n`` samples."""
    rng = np.random.default_rng(seed)
    a = (0.3 * rng.standard_normal(n)).astype(np.float32)
    b = (np.sin(np.arange(n) * 0.05) * rng.random(n)).astype(np.float32)
    return a, b


# ---------------------------------------------------------------- spectral

# 500 samples: shorter than n_fft, one frame padded by the clamped gather
@pytest.mark.parametrize("n", [500, 1024, 1300, 30000])
def test_spectral_functions_match_mst_tpu(n):
    a, b = _pcm_pair(n, n)
    got = spectral.stft(a, device="cpu").numpy()
    want = np.asarray(jaudio.stft(a))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    got = spectral.mel_spectrogram(a, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jaudio.mel_spectrogram(a)),
                               rtol=1e-5)
    np.testing.assert_allclose(spectral.log_mel(a, device="cpu").numpy(),
                               np.asarray(jaudio.log_mel(a)), atol=1e-5)
    got = spectral.spectral_similarity(a, b, device="cpu")
    assert abs(got - jaudio.spectral_similarity(a, b)) <= SIM_ATOL
    assert abs(spectral.spectral_similarity(a, a, device="cpu") - 1) <= 1e-6


def test_short_pcm_frame_is_padded_with_its_last_sample():
    """The frame of a PCM shorter than n_fft repeats its last sample, as
    JAX's clamping gather gives it."""
    a, _ = _pcm_pair(500, 1)
    padded = np.concatenate([a, np.full(1024 - 500, a[-1], np.float32)])
    got = spectral.stft(a, device="cpu")
    want = spectral.stft(padded, device="cpu")
    assert got.shape == (1, 513)
    assert torch.equal(got, want)


def test_window_and_filterbank_match_mst_tpu():
    np.testing.assert_allclose(spectral.hann(1024, device="cpu").numpy(),
                               np.asarray(jaudio.spectral.hann(1024)),
                               rtol=0, atol=1e-7)
    for kw in ({}, dict(n_mels=40, n_fft=512, fmin=30.0, fmax=8000.0)):
        got = spectral.mel_filterbank(device="cpu", **kw)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      jaudio.mel_filterbank(**kw))


def test_spectral_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = _pcm_pair(2048, 2)
    for call in (lambda: spectral.stft(a), lambda: spectral.hann(8),
                 lambda: spectral.mel_filterbank(),
                 lambda: spectral.spectral_similarity(a, b)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# --------------------------------------------------------------- synthesis

@pytest.mark.parametrize("name", SMOKE_SONGS)
def test_render_bit_equal_to_mst_tpu(name):
    path = os.path.join(SMOKE, f"{name}.mid")
    j_data, t_data = j_load(path), t_load(path)
    for max_seconds in (None, 4.0, 0.02):
        got = taudio.render_midi(t_data, max_seconds=max_seconds)
        want = jaudio.render_midi(j_data, max_seconds=max_seconds)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), max_seconds
    j_channels, j_info = jevents.read_midi(j_data)
    t_channels, t_info = tevents.read_midi(t_data)
    for jc, tc in zip(j_channels, t_channels):
        pitched = jc["instrument_id"] >= 0
        got = taudio.render_notes(tevents.pair_notes(tc["messages"]),
                                  t_info.ticks_per_beat, t_info.tempo,
                                  pitched=pitched, total_seconds=3.0)
        want = jaudio.render_notes(jevents.pair_notes(jc["messages"]),
                                   j_info.ticks_per_beat, j_info.tempo,
                                   pitched=pitched, total_seconds=3.0)
        assert got.tobytes() == want.tobytes(), jc["instrument_id"]


def test_mp3_availability_and_errors_match(tmp_path):
    assert tmp3.available() == jmp3.available()
    not_mp3 = tmp_path / "song.mp3"
    not_mp3.write_bytes(b"MThd" + bytes(64))
    errors = []
    for module in (jmp3, tmp3):
        with pytest.raises((IOError, module.Mp3Unavailable)) as info:
            module.load_mp3(str(not_mp3))
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[0] == errors[1]
    x = np.sin(np.arange(4800) * 0.01).astype(np.float32)
    assert tmp3.resample(x, 48000, 22050).tobytes() == \
        jmp3.resample(x, 48000, 22050).tobytes()


# ------------------------------------------------------- analysis, utils

def _note_arrays(seed, n=300):
    rng = np.random.default_rng(seed)
    time = np.sort(rng.integers(0, 20000, n))
    fields = dict(note_id=rng.integers(0, 128, n).astype(np.int32),
                  time=time, end_time=time + rng.integers(1, 960, n),
                  velocity=rng.random(n))
    return jevents.NoteArray(**fields), tevents.NoteArray(**fields)


@pytest.mark.parametrize("fn", ["notes_dist", "keys_dist",
                                "keys_dist_vector"])
def test_analysis_matches_mst_tpu(fn):
    info_path = os.path.join(SMOKE, "comp_0.mid")
    j_info = jevents.read_midi(j_load(info_path))[1]
    t_info = tevents.read_midi(t_load(info_path))[1]
    j_notes, t_notes = _note_arrays(3)
    if fn == "keys_dist_vector":
        got = tanalysis.keys_dist_vector(t_notes)
        want = janalysis.keys_dist_vector(j_notes)
        assert got.tobytes() == want.tobytes()
        return
    kwargs = dict(instrument_name="Piano")
    got = getattr(tanalysis, fn)(t_info, t_notes, **kwargs)
    want = getattr(janalysis, fn)(j_info, j_notes, **kwargs)
    assert got == want and list(got) == list(want)


def _utils_cases(tmp_path):
    (tmp_path / "a" / "b").mkdir(parents=True)
    for name in ("x.mid", "a/y.mid", "a/b/z.txt"):
        (tmp_path / name).write_text(name)
    rows = [{"song": "s", "dist": {"C": 1.0, "D": 0.5}, "n": 3},
            {"song": "t", "dist": {"C": 0.0}, "n": 1}]
    return {
        "freeze": lambda u: u.freeze([1, {2, 3}, (4, [5])]),
        "group_by": lambda u: (u.group_by(rows, key="n"),
                               u.group_by(rows, attr="__class__",
                                          save_indices=True),
                               u.group_by([3, 1, 3], func=len)),
        "flatten": lambda u: u.flatten([[1, 2], [], [3]]),
        "dict_map": lambda u: (u.dict_map(str, {"a": 1}),
                               u.dict_map(abs, {"a": {"b": -2}}, True)),
        "iter_all_files": lambda u: sorted(
            os.path.relpath(p, tmp_path)
            for p in u.iter_all_files(str(tmp_path), "**/*.mid")),
        "normalize_dist": lambda u: (u.normalize_dist([1, 3]).tolist(),
                                     u.normalize_dist([0, 0]).tolist()),
        "round_number": lambda u: [u.round_number(x, p) for x, p in
                                   ((7, 4), (6, 4), (-3.5, 1), (2.3, 0.5))],
        "cross_entropy": lambda u: float(u.cross_entropy(
            np.array([0.2, 0.8, 0.0]), np.array([0.5, 0.5, 0.0]))),
        "list2df": lambda u: u.list2df(rows, flatten=True,
                                       columns=("song", "n"),
                                       include_all_columns=True
                                       ).to_csv(index=False),
        "to_1d_array": lambda u: [list(x) for x in
                                  u.as_1d_array([[1], [2, 3]])],
        "random_sample": lambda u: u.random_sample(
            list(range(20)), 5, rng=np.random.default_rng(4)),
    }


@pytest.mark.parametrize("name", ["freeze", "group_by", "flatten",
                                  "dict_map", "iter_all_files",
                                  "normalize_dist", "round_number",
                                  "cross_entropy", "list2df", "to_1d_array",
                                  "random_sample"])
def test_utils_match_mst_tpu(name, tmp_path):
    case = _utils_cases(tmp_path)[name]
    assert case(tutils) == case(jutils)


def test_save_to_csv_byte_equal(tmp_path):
    rows = [{"a": 1, "b": 0.25}, {"a": 2, "b": "x"}]
    for pkg, label in ((jutils, "j"), (tutils, "t")):
        path = str(tmp_path / label / "out.csv")
        pkg.save_to_csv(path, data=rows)
        pkg.save_to_csv(path, a=3, b=None)
        pkg.save_to_csv(path, data=rows[:1], when_exists="overwrite")
        pkg.save_to_csv(path, data=rows[1:], fieldnames=["b", "a"])
    assert (tmp_path / "t" / "out.csv").read_bytes() == \
        (tmp_path / "j" / "out.csv").read_bytes()
    with pytest.raises(ValueError):
        tutils.save_to_csv(str(tmp_path / "z.csv"), when_exists="skip")


def test_corpus_stats_csv_byte_equal(tmp_path):
    (tmp_path / "corpus").mkdir()
    _write_songs(tmp_path / "corpus", (0, 245, 250))
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    outs = []
    for script in ("corpus-stats.py", "corpus-stats-torch.py"):
        out = tmp_path / f"{script}.csv"
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, script),
             str(tmp_path / "corpus"), "--sample", "2", "--seed", "5",
             "--out", str(out)], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        outs.append((out.read_bytes(), proc.stdout))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1].replace("corpus-stats.py", "corpus-stats-torch.py") \
        == outs[1][1]


# ---------------------------------------------------- transfer_and_evaluate

def test_transfer_and_evaluate_matches_mst_tpu(bundles, tmp_path):
    j_bundle, t_bundle = bundles
    comp, = _write_songs(tmp_path, (0,))
    styles = _write_songs(tmp_path, (235, 245))
    want = jt.transfer_and_evaluate(j_bundle, comp, styles,
                                    str(tmp_path / "jax"))
    got = tt.transfer_and_evaluate(t_bundle, comp, styles,
                                   str(tmp_path / "torch"))

    def shape(scores, root):
        return {os.path.relpath(p, root): sorted((k, v is None)
                                                 for k, v in e.items())
                for p, e in scores.items()}

    assert shape(got, tmp_path / "torch") == shape(want, tmp_path / "jax")
    assert len(got) == 1 + len(styles)
    comp_data = j_load(comp)
    style_data = {os.path.basename(s)[:-4]: j_load(s) for s in styles}
    for path, entry in got.items():
        data = j_load(path)
        ref = {"vs_composition": jaudio.spectral_similarity_midi(comp_data,
                                                                 data)}
        for name, sdata in style_data.items():
            if f"({name} style)" in path:
                ref["vs_style"] = jaudio.spectral_similarity_midi(sdata, data)
        assert entry.keys() == ref.keys()
        for key, score in entry.items():
            assert -1.0 <= score <= 1.0
            assert abs(score - ref[key]) <= SIM_ATOL, (path, key)
