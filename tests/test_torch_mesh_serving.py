"""Serving over a device mesh in the port (``ModelBundle(mesh=...)``)
against mst_tpu's ``ModelBundle(mesh=...)``, on the CPU.

The port's mesh is ``parallel.create_device_mesh(n, devices=["cpu"] *
n)``: one process, n shards on one device; mst_tpu's is ``create_mesh(
n_data=n, n_seq=1)`` over n of the 8 virtual CPU devices that
tests/conftest.py forces. Both use the committed ``snapshots/4900``
weights at full width and the songs of tests/test_torch_transfer.py.

- ``transfer_styles`` at n = 3 and 4 ("mixed": two extraction groups;
  "percussion": one, which mst_tpu runs as one ``transfer_fused`` program
  and the port over a mesh as extraction, then apply): the same relative
  paths as mst_tpu's, and every file byte-equal or differing only in
  fp32-boundary cells (mst_torch.parity); against the port's unsharded
  request under the same rule, with the count of files that differ
  (measured: 0 of 8 in every case);
- ``extract_styles``: the real songs' latents within
  tests/test_torch_serving.py's tolerance of the port's unsharded
  extraction (a batch of another size may sum in another order on the
  CPU), mst_tpu's mesh latents equal to its unsharded ones, and the port's
  gap to mst_tpu no larger over the mesh than without it, within that
  tolerance, and within ``MESH_LATENT_ATOL`` of mst_tpu's mesh latents
  (without a mesh the gap is already above the serving tolerance for the
  style song, seed 235: up to 4.7e-4 in its melody latents, 2.3e-5 of
  their largest value; the files still pass the fp32-boundary rule);
- the padding: 3 songs over 4 shards and 8 jobs over 3 keep JAX's shapes
  (``data_axis_size``, ``shard_rows``), and no pad row reaches a file;
- ``replay_log_flops`` of a mesh request's log equals mst_tpu's count of
  its own mesh request (a request pins none of tests/test_torch_flops.py's
  two differences);
- ``create_device_mesh``: the data axis, repeated devices, and no card;
  a ``device`` beside a mesh must name its first device;
- tools/profile_mesh_torch.py on the CPU: the mesh's stages by shard and
  its files against the single-device request's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu import transfer as jt
from mst_tpu.ops import pallas_grid
from mst_tpu.parallel import create_mesh
from mst_tpu.runtime import flops as jf
from mst_torch import transfer as tt
from mst_torch.parallel import DeviceMesh, create_device_mesh
from mst_torch.parity import midi_differences
from mst_torch.runtime import flops
from tests.test_torch_train import _assert_close
from tests.test_torch_transfer import _write_songs, bundles  # noqa: F401

# tests/test_torch_transfer.py's seeds: compositions 0 and 250 (two
# extraction groups) or 0 and 245 (one), style 235
CASES = {"mixed": (0, 250), "percussion": (0, 245)}
STYLE_SEED = 235
# the port's mesh latents against mst_tpu's: about twice the largest gap
# measured on these songs (style 1.5e-5, melody 4.7e-4, rhythm 1.4e-4,
# each in the style song, seed 235)
MESH_LATENT_ATOL = {"style": 5e-5, "melody": 1e-3, "rhythm": 3e-4}


@pytest.fixture(autouse=True)
def _jax_mesh_gate(monkeypatch):
    """mst_tpu's create_mesh registers its mesh with the note-grid kernel's
    dispatch, a module global: restore it after each test."""
    monkeypatch.setattr(pallas_grid, "_MESH", pallas_grid._MESH)


@pytest.fixture(scope="module")
def requests(bundles, tmp_path_factory):
    """Each case's songs and the port's unsharded request on them, written
    once: {case: (compositions, styles, written paths, their root)}."""
    out = {}
    for case, seeds in CASES.items():
        root = tmp_path_factory.mktemp(case)
        comps = _write_songs(root, seeds)
        styles = _write_songs(root, (STYLE_SEED,))
        written = tt.transfer_styles(bundles[1], comps, styles,
                                     str(root / "plain"))
        out[case] = comps, styles, written, root / "plain"
    return out


def _bundles_over(bundles, n):
    """(mst_tpu's bundle, the port's bundle) over a data axis of n."""
    j_bundle, t_bundle = bundles
    j_mesh = jt.ModelBundle(
        model=j_bundle.model, params=j_bundle.params,
        mesh=create_mesh(n_data=n, n_seq=1, devices=jax.devices()[:n]))
    t_mesh = tt.ModelBundle(model=t_bundle.model,
                            mesh=create_device_mesh(n, devices=["cpu"] * n))
    return j_mesh, t_mesh


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _differing(want, got):
    """Files of two requests that are not byte-equal; each pair must pass
    the fp32-boundary rule."""
    n = 0
    for a, b in zip(want, got):
        equal, faults, _ = midi_differences(_read(a), _read(b))
        assert not faults, (os.path.basename(a), faults)
        n += not equal
    return n


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_transfer_styles_over_a_mesh_matches_mst_tpu(bundles, requests,
                                                     tmp_path, case, n):
    j_mesh, t_mesh = _bundles_over(bundles, n)
    comps, styles, plain, plain_root = requests[case]
    want = jt.transfer_styles(j_mesh, comps, styles, str(tmp_path / "jax"))
    got = tt.transfer_styles(t_mesh, comps, styles, str(tmp_path / "mesh"))
    assert len(got) == 2 * 4
    assert [os.path.relpath(p, tmp_path / "mesh") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want] == \
        [os.path.relpath(p, plain_root) for p in plain]
    _differing(want, got)
    assert _differing(plain, got) == 0
    # extraction and apply ran on every shard; nothing ran as one program
    runs = t_mesh.programs.runs
    assert sum(runs.values()) == 2 * n * (2 if case == "mixed" else 1)
    assert not any(k.startswith("transfer_fused") for k in runs)


def test_extract_styles_over_a_mesh_matches_mst_tpu(bundles, tmp_path):
    """3 songs (two groups) over 4 shards: each group padded to 4 rows."""
    j_mesh, t_mesh = _bundles_over(bundles, 4)
    paths = _write_songs(tmp_path, (0, 250, STYLE_SEED))
    j_songs = [jt.get_model_input(p)[1] for p in paths]
    t_songs = [tt.get_model_input(p)[1] for p in paths]
    want, want_loc = jt.extract_styles(j_mesh, j_songs)
    with torch.inference_mode():
        got, got_loc = tt.extract_styles(t_mesh, t_songs)
        plain, plain_loc = tt.extract_styles(bundles[1], t_songs)
    j_plain, j_loc = jt.extract_styles(bundles[0], j_songs)
    assert got_loc == want_loc == plain_loc == j_loc
    for g, w, p, jp in zip(got, want, plain, j_plain):
        assert w.style.shape[0] == 4                 # JAX keeps the pad rows
        assert g.n_bars == w.n_bars == p.n_bars
        for name in ("style", "melody", "rhythm"):
            gt, wt, pt, jpt = (getattr(x, name) for x in (g, w, p, jp))
            assert gt.shape[0] == len(g.n_bars)      # the real songs alone
            wt = np.asarray(wt)[:len(g.n_bars)]
            jpt = np.asarray(jpt)
            _assert_close(gt.numpy(), pt.numpy(), name)
            _assert_close(wt, jpt, name)
            tol = 1e-5 + 2e-6 * np.abs(jpt).max()
            gap = np.abs(gt.numpy() - wt).max()
            assert gap <= np.abs(pt.numpy() - jpt).max() + tol, name
            assert gap <= MESH_LATENT_ATOL[name], (name, gap)


def test_padding_keeps_jax_shapes_and_never_reaches_a_file(bundles,
                                                          tmp_path):
    """3 songs over 4 shards: 4 rows, the last an all-zero song of length
    1 whose records are all invalid; 8 jobs over 3 shards: 9 job rows,
    the last a copy of job 8, and 8 files equal to the unsharded ones."""
    j_mesh, t_mesh = _bundles_over(bundles, 4)
    assert t_mesh.data_axis_size() == j_mesh.data_axis_size() == 4
    x = np.arange(8 * 5, dtype=np.float32).reshape(8, 5)
    want = [np.asarray(s.data) for s in sorted(
        j_mesh.shard_rows(jnp.asarray(x)).addressable_shards,
        key=lambda s: s.index[0].start)]
    got = t_mesh.shard_rows(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError):
        t_mesh.shard_rows(torch.zeros(3, 5))

    paths = _write_songs(tmp_path, (0, 245, STYLE_SEED))
    songs = [tt.get_model_input(p)[1] for p in paths]
    shards, statics, Rs = tt._extract_shards(t_mesh, songs, 4, True)
    j_args, j_statics, j_Rs = jt._extract_inputs(
        j_mesh, [jt.get_model_input(p)[1] for p in paths], 4, True)
    assert len(shards) == 4 and statics["B"] * 4 == j_statics["B"] == 4
    assert (statics["Cb"], statics["Rb"]) == (j_statics["Cb"],
                                              j_statics["Rb"])
    assert Rs == j_Rs
    lengths = torch.cat([s[5] for s in shards])
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(j_args[5]))
    pad = shards[3]
    assert not pad[0][5].any() and not pad[1][5].any()   # no valid record
    assert not pad[6].any() and not pad[4].any()         # no channel

    # 8 jobs over 3 shards: the latents of one song, 8 times
    t_mesh3 = _bundles_over(bundles, 3)[1]
    with torch.inference_mode():
        style, melody, rhythm, bars = tt.extract_style(bundles[1], songs[0])
    infos = [songs[0].info] * 8
    n_inst = [1, 2, 3, 2, 1, 2, 3, 2]
    out = {}
    for label, bundle in (("plain", bundles[1]), ("mesh", t_mesh3)):
        bundle.call_log = []
        save = [str(tmp_path / label / f"job{j}.mid") for j in range(8)]
        tt.apply_styles(bundle, infos, [style] * 8, [melody] * 8,
                        [rhythm] * 8, n_inst, save, [bars] * 8)
        out[label] = save
        calls, bundle.call_log = bundle.call_log, None
    assert [c[3] for c in calls] == [0, 1, 2]
    job_rows = [c[1][3:] for c in calls]                 # 3 rows a shard
    assert [tuple(r[2].tolist()) for r in job_rows] == [(1, 2, 3), (2, 1, 2),
                                                        (3, 2, 2)]
    assert sorted(os.listdir(tmp_path / "mesh")) == \
        sorted(os.listdir(tmp_path / "plain"))
    for a, b in zip(out["plain"], out["mesh"]):
        assert _read(a) == _read(b), b


def test_replay_log_flops_over_a_mesh_matches_mst_tpu(bundles, requests,
                                                      tmp_path):
    """The "percussion" request over 3 shards (3 songs, 6 jobs): mst_tpu
    logs one ``transfer_fused`` call, the port an extraction and an apply
    on each shard; the counts are equal integers."""
    j_mesh, t_mesh = _bundles_over(bundles, 3)
    comps, styles = requests["percussion"][:2]
    j_mesh.call_log = []
    jt.transfer_styles(j_mesh, comps, styles, str(tmp_path / "jax"))
    want = jf.replay_log_flops(j_mesh._raw, j_mesh.call_log)
    assert [c[0].split(":")[0] for c in j_mesh.call_log] == \
        ["transfer_fused"]
    t_mesh.call_log = log = []
    tt.transfer_styles(t_mesh, comps, styles, str(tmp_path / "mesh"))
    assert [(key.split(":")[0], shard) for key, _, _, shard in log] == \
        [("raster_extract", s) for s in range(3)] + \
        [("fused", s) for s in range(3)]
    got = flops.replay_log_flops(t_mesh, log)
    assert got > 0
    assert got == int(want)


def test_create_device_mesh_layout_and_no_card(monkeypatch):
    mesh = create_device_mesh(2, devices=["cpu"] * 5)
    assert isinstance(mesh, DeviceMesh)
    assert mesh.shape == {"data": 2, "seq": 1}
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert create_device_mesh(devices=["cpu"] * 4).shape == \
        {"data": 4, "seq": 1}
    for n in (0, 6):
        with pytest.raises(ValueError):
            create_device_mesh(n, devices=["cpu"] * 5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_device_mesh()
    with pytest.raises(ValueError, match="first device"):
        tt.ModelBundle(model=torch.nn.Linear(1, 1), device="cuda:0",
                       mesh=create_device_mesh(1, devices=["cpu"]))
    bundle = tt.ModelBundle(model=torch.nn.Linear(1, 1), device="cpu",
                            mesh=create_device_mesh(2, devices=["cpu"] * 2))
    assert bundle.device == torch.device("cpu")
    assert bundle.shard_devices == [torch.device("cpu")] * 2


def test_mesh_profile_tool_on_the_cpu(requests, capsys):
    """tools/profile_mesh_torch.py --device cpu over 2 shards, one turn, the
    "percussion" songs with the style twice (6 jobs): the mesh's stages by
    shard, the single request's one shard, files against each other."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import profile_mesh_torch

    comps, styles = requests["percussion"][:2]
    result = profile_mesh_torch.main([
        "--device", "cpu", "--shards", "2", "--rounds", "1",
        "--repeat-styles", "2", "--compositions", *comps,
        "--styles", *styles])
    (batch,) = result["batches"]
    assert batch["jobs"] == 6
    assert batch["files"]["byte_equal"] == batch["files"]["files"] > 0
    mesh, single = batch["bundles"]["mesh"], batch["bundles"]["single"]
    assert {tt.STAGE_LATENT_GATHER, tt.STAGE_LATENT_COPY} <= \
        set(mesh["stages_ms"])
    for stage in (tt.STAGE_SHARD_EXTRACT, tt.STAGE_SHARD_APPLY,
                  tt.STAGE_SHARD_FETCH):
        assert {stage.format(0), stage.format(1)} <= set(mesh["stages_ms"])
        assert stage.format(1) not in single["stages_ms"]
    # the single request is one transfer_fused program: no gather, no copy
    assert tt.STAGE_LATENT_GATHER not in single["stages_ms"]
    assert all(ms >= 0 for r in (mesh, single)
               for ms in r["stages_ms"].values())
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == result
