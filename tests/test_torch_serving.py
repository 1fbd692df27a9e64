"""The rest of the port's serving path against mst_tpu, on the CPU.

- ``sparsify_velocity_bias`` on carried-over params: equal to mst_tpu's;
  ``demo_params`` deterministic per seed;
- ``save_packed_channels``: byte-equal ``.mid`` on seeded packed arrays;
- ``extract_style``: latents within tests/test_fused_tails.py's
  fp32-reassociation rule of mst_tpu's (rtol 1e-5, atol 1e-5 + 2e-6 *
  max|want|, as tests/test_torch_train.py holds whole-model results): the
  two sum in other orders inside the 64-bar recurrences, the conv and the
  matmuls;
- ``apply_style`` / ``apply_styles`` on mst_tpu's latents: ``.mid`` files
  under the fp32-boundary rule (mst_torch.parity);
- ``runtime.ref_checkpoint``: bit-equal to mst_tpu's import followed by
  ``weights.state_dict_from_flax``, and its errors;
- the CLIs ``batch-style-transfer-torch.py`` and ``style-transfer-torch.py``
  (``--snapshots``, ``--weights``, ``--seed``): exact paths and bytes.

The full-width (``ModelConfig()``) tests share one module-scoped bundle
pair on the committed ``snapshots/4900`` weights and short
tools/make_corpus.py songs (32-64 bars).
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mst_tpu import transfer as jt
from mst_tpu.runtime import ref_checkpoint as jref
from mst_torch import transfer as tt
from mst_torch import weights
from mst_torch.models import StyleTransferModel
from mst_torch.parity import midi_differences
from mst_torch.runtime import ref_checkpoint as tref
from tests.test_torch_train import _assert_close
from tests.test_torch_transfer import _nest, _write_songs, bundles  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# make_corpus seeds (tests/test_torch_transfer.py): 0 and 235 share
# beats-per-bar and both have percussion
COMP_SEED, STYLE_SEED = 0, 235


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    """(paths, mst_tpu songs, port songs) of the composition and the
    style song."""
    paths = _write_songs(tmp_path_factory.mktemp("songs"),
                         (COMP_SEED, STYLE_SEED))
    return (paths, [jt.get_model_input(p)[1] for p in paths],
            [tt.get_model_input(p)[1] for p in paths])


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _assert_parity(want_paths, got_paths):
    """Every pair byte-equal or differing only in fp32-boundary cells."""
    for a, b in zip(want_paths, got_paths):
        equal, faults, _ = midi_differences(_read(a), _read(b))
        assert not faults, (os.path.basename(a), faults)


# ------------------------------------------------------------ demo params

def test_sparsify_velocity_bias_matches_mst_tpu():
    flat = weights.load_npz()
    want = weights.state_dict_from_flax(
        jt.sparsify_velocity_bias({"params": _nest(flat)}))
    got = tt.sparsify_velocity_bias(weights.state_dict_from_flax(flat))
    assert sorted(got) == sorted(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   msg=key)
    for name in ("pitched_style_applier", "unpitched_style_applier"):
        assert float(got[f"{name}.linear.bias"][1]) == -5.0


def test_demo_params_are_deterministic_per_seed():
    a, b, c = (tt.demo_params(seed=s) for s in (3, 3, 4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert float(a["pitched_style_applier.linear.bias"][1]) == -5.0
    # a bundle loads them, and the demo leaves the model's own init alone
    model = StyleTransferModel()
    model.load_state_dict(a)
    fresh = StyleTransferModel().init_parameters(3).state_dict()
    assert float(fresh["pitched_style_applier.linear.bias"][1]) != -5.0


# --------------------------------------------------------- packed decode

def test_save_packed_channels_byte_equal(songs, tmp_path):
    from mst_tpu.ops.rasterize import Rasterizer as JRasterizer
    from mst_torch.ops.rasterize import Rasterizer

    _, j_songs, t_songs = songs
    rng = np.random.default_rng(7)
    C, R, T = 3, j_songs[0].pitched_shape[1], j_songs[0].info.n_beats

    def packed(c, n):
        shape = (c, R, T, 10, n)
        vel = rng.integers(1, 128, shape).astype(np.uint8)
        vel[rng.random(shape) < 0.97] = 0
        return (rng.integers(0, 4000, shape).astype(np.uint16), vel,
                rng.integers(0, 3, shape).astype(np.uint8))

    packed_p, packed_u = packed(C, 56), packed(1, 47)
    instruments = [0, 33, 81]
    for label, u in (("with_percussion", packed_u), ("pitched_only", None)):
        want, got = tmp_path / f"j_{label}.mid", tmp_path / f"t_{label}.mid"
        jt.save_packed_channels(JRasterizer(j_songs[0].info), packed_p, u,
                                instruments, str(want))
        tt.save_packed_channels(Rasterizer(t_songs[0].info), packed_p, u,
                                instruments, str(got))
        assert _read(got) == _read(want), label


# ------------------------------------------------------- extract / apply

def test_extract_style_matches_mst_tpu(bundles, songs):
    j_bundle, t_bundle = bundles
    _, j_songs, t_songs = songs
    want = jt.extract_style(j_bundle, j_songs[0])
    got = tt.extract_style(t_bundle, t_songs[0])
    assert got[3] == want[3]
    for name, g, w in zip(("style", "melody", "rhythm"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        _assert_close(g.numpy(), w, name)


def test_apply_style_and_styles_match_mst_tpu(bundles, songs, tmp_path):
    """mst_tpu's latents go into both packages: the reconstruction and the
    styled job as one ``apply_styles`` batch, and the styled job alone
    through ``apply_style``."""
    j_bundle, t_bundle = bundles
    _, j_songs, t_songs = songs
    j_comp, j_style = j_songs
    style_c, melody, rhythm, n_bars = jt.extract_style(j_bundle, j_comp)
    style_s = jt.extract_style(j_bundle, j_style)[0]
    latents = [np.array(a) for a in (style_c, style_s, melody, rhythm)]
    style_c, style_s, melody, rhythm = latents
    n_inst = [len(j_comp.instruments), len(j_style.instruments)]

    def infos(pkg, songs_):
        comp, style = songs_
        return [copy.deepcopy(comp.info),
                pkg.combine_info(style_info=style.info,
                                 melody_info=copy.deepcopy(comp.info))]

    def run(pkg, bundle, songs_, label):
        paths = [str(tmp_path / label / f"{i}.mid") for i in range(3)]
        pkg.apply_styles(bundle, infos(pkg, songs_), [style_c, style_s],
                         [melody, melody], [rhythm, rhythm], n_inst,
                         paths[:2], [n_bars, n_bars])
        pkg.apply_style(bundle, infos(pkg, songs_)[1], style_s, melody,
                        rhythm, n_inst[1], paths[2], n_bars=n_bars)
        return paths

    want = run(jt, j_bundle, j_songs, "jax")
    got = run(tt, t_bundle, t_songs, "torch")
    _assert_parity(want, got)
    # apply_style alone writes the styled job of the batch
    assert _read(got[2]) == _read(got[1])


# -------------------------------------------------------- ref_checkpoint

def _reference_state_dict(seed):
    """Random values under the reference's names: the port's names, with
    ``.module`` before the leaf for every other parameter (the
    ``Distributed`` wrapper)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (name, like) in enumerate(StyleTransferModel().state_dict()
                                     .items()):
        if i % 2:
            prefix, leaf = name.rsplit(".", 1)
            name = f"{prefix}.module.{leaf}"
        out[name] = torch.from_numpy(
            rng.standard_normal(tuple(like.shape)).astype(np.float32))
    return out


def test_state_dict_from_reference_matches_mst_tpu_import():
    ref = _reference_state_dict(11)
    template = _nest(weights.load_npz())
    flax_params, unused = jref.flax_params_from_torch_state_dict(ref,
                                                                 template)
    assert not unused
    want = weights.state_dict_from_flax(flax_params)
    got = tref.state_dict_from_reference(ref)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], want[key]), key
    StyleTransferModel().load_state_dict(got)


@pytest.mark.parametrize("fault", ["unused", "shape", "missing"])
def test_state_dict_from_reference_raises(fault):
    ref = _reference_state_dict(12)
    key = next(iter(ref))
    if fault == "unused":
        ref["extra.weight"] = torch.zeros(3)
        error = ValueError
    elif fault == "shape":
        ref[key] = torch.zeros(tuple(ref[key].shape) + (1,))
        error = ValueError
    else:
        del ref[key]
        error = KeyError
    with pytest.raises(error):
        tref.state_dict_from_reference(ref)


def test_load_reference_snapshot_reads_a_whole_model_pickle(tmp_path):
    model = StyleTransferModel().init_parameters(5)
    path = tmp_path / "100.pkl"
    torch.save(model, path)
    got = tref.load_reference_snapshot(str(path), str(tmp_path))
    want = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


# ------------------------------------------------------------------ CLIs

def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, os.path.join(ROOT, script),
                           *map(str, args)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def _cli(script, *args):
    proc = _run(script, *args, "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.splitlines()


@pytest.mark.parametrize("script", ["batch-style-transfer-torch.py",
                                    "style-transfer-torch.py"])
def test_transfer_clis_default_to_cuda_and_raise_without_it(songs, script,
                                                            tmp_path):
    (comp, style), _, _ = songs
    args = (("--compositions", comp, "--styles", style)
            if script.startswith("batch") else (comp, style))
    proc = _run(script, *args, "--out", tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not os.listdir(tmp_path)


@pytest.fixture(scope="module")
def library_run(bundles, songs, tmp_path_factory):
    """(output root, written paths) of ``transfer_styles`` in process on
    the committed npz: what both CLIs must write with those weights."""
    _, t_bundle = bundles
    (comp, style), _, _ = songs
    root = tmp_path_factory.mktemp("library")
    return root, tt.transfer_styles(t_bundle, [comp], [style], str(root))


def _assert_same_run(got, got_root, want, want_root):
    assert [os.path.relpath(p, got_root) for p in got] == \
        [os.path.relpath(p, want_root) for p in want]
    assert len(got) == 4
    for a, b in zip(want, got):
        assert _read(a) == _read(b), os.path.basename(a)


def test_batch_cli_writes_the_paths_of_transfer_styles(songs, library_run,
                                                       tmp_path):
    (comp, style), _, _ = songs
    got = _cli("batch-style-transfer-torch.py", "--compositions", comp,
               "--styles", style, "--weights", weights.SNAPSHOT_NPZ,
               "--out", tmp_path)
    _assert_same_run(got, tmp_path, library_run[1], library_run[0])


def test_style_cli_snapshots_equal_weights(songs, library_run, tmp_path):
    """A checkpoint that ``CheckpointManager.save`` writes from a train
    state on the committed npz gives the files of the same run on the npz
    (``--weights``: ``ModelBundle.from_npz`` + ``transfer_style``, which
    is ``library_run``)."""
    from mst_torch.config import Config
    from mst_torch.runtime.checkpoint import CheckpointManager
    from mst_torch.runtime.train import create_train_state

    (comp, style), _, _ = songs
    model = StyleTransferModel()
    model.load_state_dict(weights.state_dict_from_flax(weights.load_npz()))
    state = create_train_state(Config(), device="cpu", model=model)
    CheckpointManager(str(tmp_path / "ckpt")).save(4900, state)
    got = _cli("style-transfer-torch.py", comp, style, "--snapshots",
               tmp_path / "ckpt", "--out", tmp_path / "out")
    _assert_same_run(got, tmp_path / "out", library_run[1], library_run[0])


@pytest.mark.parametrize("script", ["batch-style-transfer-torch.py",
                                    "style-transfer-torch.py"])
def test_cli_without_weights_runs_demo_params(songs, script, tmp_path):
    """Without weights (the batch CLI) or with ``--seed`` (the style CLI)
    a CLI runs ``demo_params(seed)``: four files that parse (the
    sparsified bias may leave a styled file silent, as mst_tpu's demo
    params may)."""
    from mst_torch.io import smf

    (comp, style), _, _ = songs
    args = (("--compositions", comp, "--styles", style)
            if script.startswith("batch") else (comp, style))
    written = _cli(script, *args, "--seed", 1, "--out", tmp_path)
    assert len(written) == 4
    for path in written:
        smf.parse_midi_bytes(_read(path))
