"""The bf16 numeric policies of the port (mst_torch.ops.precision) against
the JAX package's (mst_tpu.ops.precision), on the CPU.

Mirrors tests/test_precision.py:53-150 at NARROW widths, on one numpy
batch and one set of flax parameters shared by both frameworks. Each test
holds the port under a policy to mst_tpu under the same policy and to the
port's own fp32 run:

- against mst_tpu (same policy): the two round at the same points, so
  they differ only where an fp32 sum taken in another order lands on the
  other side of a bf16 rounding boundary (a step of 2**-8 relative), and
  by what that moves downstream. Forward outputs within rtol 1e-2, atol
  1e-3; per-step losses within rtol 5e-3, atol 1e-3 (the atol covers loss
  components near 0; the largest measured differences when this was
  written: 1.3e-4 on the forward, 3.5e-4 on a loss component).
- against the port's fp32 run: tests/test_precision.py's tolerances
  (forward rtol 0.1, atol 0.05; losses rtol 0.05, atol 0.02).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.config import Config as JConfig
from mst_tpu.config import ModelConfig as JModelConfig
from mst_tpu.models import StyleTransferModel as JModel
from mst_tpu.ops import precision as jp
from mst_tpu.runtime import train as jtr
from mst_torch import weights
from mst_torch.config import Config, ModelConfig
from mst_torch.models import StyleTransferModel
from mst_torch.ops import precision as tp
from mst_torch.runtime import train as ttr
from tests.test_torch_model import NARROW, _params_like

FWD_TOL = dict(rtol=1e-2, atol=1e-3)       # port vs mst_tpu, same policy
FWD_FP32_TOL = dict(rtol=0.1, atol=0.05)   # bf16 vs fp32
LOSS_TOL = dict(rtol=5e-3, atol=1e-3)      # port vs mst_tpu, same policy
LOSS_FP32_TOL = dict(rtol=0.05, atol=0.02)  # bf16 vs fp32


def _toy_fields(B=2, C=2, R=4, T=4):
    """tests/test_precision.py's toy batch, drawn with numpy."""
    rng = np.random.default_rng(7)
    pitched = ((rng.random((B, C, R, T, 10, 56, 5)) > 0.9)
               * rng.random((B, C, R, T, 10, 56, 5))).astype(np.float32)
    unpitched = (rng.random((B, 1, R, T, 10, 47, 2)) > 0.9).astype(
        np.float32)
    instf = np.zeros((B, C, 51), np.float32)
    instf[:, :, 0] = 1.0
    used = np.zeros((B, 41), np.float32)
    used[:, 0] = 1.0
    return dict(mode=np.tile(np.float32([[1.0, 0.0]]), (B, 1)),
                bpm=np.full((B,), 120.0, np.float32), pitched=pitched,
                instruments_features=instf, unpitched=unpitched,
                used_instruments=used, bar_lengths=np.full((B,), R, np.int64),
                channel_mask=np.ones((B, C), np.float32),
                uchannel_mask=np.ones((B, 1), np.float32))


@pytest.fixture(scope="module")
def setup():
    """(mst_tpu model, flax params, mst_tpu batch, port batch)."""
    fields = _toy_fields()
    j_batch = jtr.Batch(**{k: jnp.asarray(v) for k, v in fields.items()})
    t_batch = ttr.Batch(**{k: torch.from_numpy(v)
                           for k, v in fields.items()})
    j_model = JModel(JModelConfig(**NARROW))
    params = _params_like(j_model.init, jax.random.PRNGKey(1), j_batch.mode,
                          j_batch.bpm, j_batch.pitched,
                          j_batch.instruments_features, j_batch.unpitched)
    return j_model, params, j_batch, t_batch


def _torch_model(params, **policy):
    model = StyleTransferModel(ModelConfig(**NARROW, **policy))
    model.load_state_dict(weights.state_dict_from_flax(params), strict=True)
    return model


def _forward_args(batch):
    return ((batch.mode, batch.bpm, batch.pitched,
             batch.instruments_features, batch.unpitched),
            dict(bar_lengths=batch.bar_lengths,
                 channel_mask=batch.channel_mask,
                 uchannel_mask=batch.uchannel_mask))


def test_bf16_forward_tracks_mst_tpu_and_fp32(setup):
    j_model, params, j_batch, t_batch = setup
    j_args, j_kwargs = _forward_args(j_batch)
    t_args, t_kwargs = _forward_args(t_batch)
    model = _torch_model(params)
    with torch.no_grad():
        _, x32, u32 = model(*t_args, **t_kwargs)
        with tp.precision("bfloat16"):
            _, x16, u16 = model(*t_args, **t_kwargs)
    with jp.precision("bfloat16"):
        _, jx16, ju16 = jax.jit(lambda p: j_model.apply(
            p, *j_args, **j_kwargs))(params)
    # outputs stay fp32; parameters are untouched
    assert x16.dtype == torch.float32 and u16.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert torch.isfinite(x16).all() and torch.isfinite(u16).all()
    for got, want in ((x16, jx16), (u16, ju16)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    for got, want in ((x16, x32), (u16, u32)):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   **FWD_FP32_TOL)
    assert not torch.equal(x16, x32)   # the policy did take effect


def test_precision_context_restores():
    assert tp.compute_dtype() == torch.float32
    assert tp.storage_dtype() == torch.float32
    with tp.precision("bfloat16"):
        assert tp.compute_dtype() == torch.bfloat16
        with tp.precision("float32", storage="bfloat16"):
            assert tp.compute_dtype() == torch.float32
            assert tp.storage_dtype() == torch.bfloat16
        assert tp.storage_dtype() == torch.float32
    assert tp.compute_dtype() == torch.float32
    with pytest.raises(RuntimeError):
        with tp.precision("bfloat16", storage="bfloat16"):
            raise RuntimeError("inside")
    assert (tp.compute_dtype(), tp.storage_dtype()) == (torch.float32,
                                                        torch.float32)
    with pytest.raises(ValueError):
        with tp.precision("float16"):
            pass


def test_storage_context_restores_and_default_is_noop():
    x = torch.ones(3)
    assert tp.cast_storage(x) is x          # fp32 default: a no-op
    assert tp.cast_operand(x) is x
    with tp.precision("float32", storage="bfloat16"):
        assert tp.storage_dtype() == torch.bfloat16
        assert tp.compute_dtype() == torch.float32
        assert tp.cast_storage(x).dtype == torch.bfloat16
        # non-fp32 inputs (int masks, already-cast tensors) pass through
        i = torch.ones(3, dtype=torch.int32)
        assert tp.cast_storage(i) is i
    assert tp.storage_dtype() == torch.float32


def test_policy_is_the_contexts_and_a_fresh_thread_sees_fp32():
    """The policy is the innermost ``precision(...)`` context's, restored
    when it closes; a thread started inside a context does not see it
    (there are no process-wide setters: callers enter the context from
    their config); a bad dtype raises."""
    import threading

    seen = []
    with tp.precision("bfloat16", storage="bfloat16"):
        thread = threading.Thread(target=lambda: seen.append(
            (tp.compute_dtype(), tp.storage_dtype())))
        thread.start()
        thread.join()
        with tp.precision("float32"):
            assert tp.compute_dtype() == torch.float32
            assert tp.storage_dtype() == torch.bfloat16   # storage as is
        assert (tp.compute_dtype(), tp.storage_dtype()) == (torch.bfloat16,
                                                            torch.bfloat16)
    assert seen == [(torch.float32, torch.float32)]
    assert (tp.compute_dtype(), tp.storage_dtype()) == (torch.float32,
                                                        torch.float32)
    with pytest.raises(ValueError):
        with tp.precision("float16"):
            pass


def test_train_step_bits_ignore_the_callers_policy(setup):
    """A train step enters its config's policy: under a caller's bf16
    context it gives the bits it gives without one. The loss and its
    gradients under that context equal bf16 compute's and differ from
    fp32's."""
    _, params, _, t_batch = setup

    def loss_and_grads(context):
        model = _torch_model(params)
        with context:
            total = ttr.loss_fn(model, t_batch, True).total
            total.backward()
        return total.detach(), [p.grad.clone() for p in model.parameters()]

    def step_bits(context):
        config = Config(model=ModelConfig(**NARROW))
        state = ttr.create_train_state(config, device="cpu",
                                       model=_torch_model(params))
        with context:
            _, vec = ttr.make_train_step(config, True)(state, t_batch)
        return vec, [p.grad.clone() for p in state.model.parameters()]

    import contextlib

    bf16 = lambda: tp.precision("bfloat16", storage="bfloat16")  # noqa: E731
    fp32 = loss_and_grads(contextlib.nullcontext())
    context = loss_and_grads(bf16())
    plain_step, outer_step = step_bits(contextlib.nullcontext()), \
        step_bits(bf16())
    assert torch.equal(plain_step[0], outer_step[0])
    assert all(torch.equal(a, b) for a, b in zip(plain_step[1],
                                                 outer_step[1]))
    assert not torch.equal(context[0], fp32[0])
    assert any(not torch.equal(a, b) for a, b in zip(context[1], fp32[1]))


def _j_losses(j_model, params, j_batch, n=5, **policy):
    config = JConfig(model=JModelConfig(**NARROW, **policy))
    opt = jtr.make_optimizer(config)
    p = jax.tree_util.tree_map(jnp.array, params)   # the step donates it
    state = jtr.TrainState(
        params=p, opt_state=opt.init(p),
        accum_grads=jax.tree_util.tree_map(jnp.zeros_like, p),
        micro_step=jnp.zeros((), jnp.int32), opt_step=jnp.zeros((), jnp.int32))
    step = jtr.make_train_step(j_model, config, True, fetch_losses=False)
    out = []
    for _ in range(n):
        state, vec = step(state, j_batch)
        out.append(np.asarray(vec))
    return np.stack(out)


def _t_run(params, t_batch, n=5, **policy):
    """n port micro-steps; returns (losses (n, 15), the state, the
    accumulated gradients after the first step)."""
    config = Config(model=ModelConfig(**NARROW, **policy))
    state = ttr.create_train_state(config, device="cpu",
                                   model=_torch_model(params, **policy))
    step = ttr.make_train_step(config, True)
    out, grads = [], None
    for i in range(n):
        out.append(step(state, t_batch)[1].numpy())
        if i == 0:      # iter_size 2: the first step's gradient is held
            grads = [p.grad for p in state.model.parameters()]
    return np.stack(out), state, grads


def _assert_fp32_state(state, grads):
    """Every parameter, accumulated gradient and Adam leaf is fp32."""
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(g is None or g.dtype == torch.float32 for g in grads)
    assert any(g is not None for g in grads)
    leaves = [v for s in state.optimizer.state.values() for v in s.values()]
    assert leaves and all(v.dtype == torch.float32 for v in leaves)


def _assert_tracks(got, want, tol):
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], **tol)


@pytest.fixture(scope="module")
def fp32_run(setup):
    _, params, _, t_batch = setup
    return _t_run(params, t_batch)[0]


@pytest.mark.parametrize("policy", [
    dict(compute_dtype="bfloat16"),
    dict(compute_dtype="bfloat16", storage_dtype="bfloat16"),
], ids=["compute", "compute+storage"])
def test_bf16_train_step_keeps_params_fp32_and_tracks_loss(setup, fp32_run,
                                                           policy):
    """A bf16-compute train step keeps every parameter and gradient fp32,
    tracks mst_tpu's step under the same policy and the port's fp32 run,
    and the loss goes down over 5 steps."""
    j_model, params, j_batch, t_batch = setup
    losses, state, grads = _t_run(params, t_batch, **policy)
    _assert_fp32_state(state, grads)
    assert np.isfinite(losses[:, 0]).all(), losses[:, 0]
    _assert_tracks(losses, _j_losses(j_model, params, j_batch, **policy),
                   LOSS_TOL)
    _assert_tracks(losses, fp32_run, LOSS_FP32_TOL)
    assert losses[-1, 0] < losses[0, 0]


def test_bf16_storage_train_step_tracks_fp32(setup, fp32_run):
    """Under storage_dtype="bfloat16" every parameter, gradient and Adam
    leaf stays fp32, the raster and the activations are stored as bf16,
    the losses track mst_tpu's bf16-storage step and the port's fp32 run,
    and the loss goes down."""
    j_model, params, j_batch, t_batch = setup
    policy = dict(storage_dtype="bfloat16")
    model = _torch_model(params, **policy)
    stored = []
    hook = model.pitched_style_applier.register_forward_hook(
        lambda m, i, out: stored.append(out.dtype))
    args, kwargs = _forward_args(t_batch)
    with torch.no_grad(), tp.precision("float32", storage="bfloat16"):
        model(*args, **kwargs)
    hook.remove()
    assert stored == [torch.bfloat16]
    losses, state, grads = _t_run(params, t_batch, **policy)
    _assert_fp32_state(state, grads)
    assert np.isfinite(losses[:, 0]).all(), losses[:, 0]
    _assert_tracks(losses, _j_losses(j_model, params, j_batch, **policy),
                   LOSS_TOL)
    _assert_tracks(losses, fp32_run, LOSS_FP32_TOL)
    assert losses[-1, 0] < losses[0, 0]


def test_device_batch_rasters_at_the_storage_dtype():
    """device_batch_from_songs(raster_dtype="bfloat16") scatters the rasters
    at bf16: the fp32 batch's rasters cast to bf16, everything else equal."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from make_corpus import generate_song
    from mst_torch.data.pipeline import get_input
    from mst_torch.io import create_midi, smf
    from mst_torch.ops.events import read_midi

    songs = []
    for seed in (0, 245):
        info, instruments = generate_song(np.random.default_rng(seed))
        data = smf.encode_midi(create_midi(info, *instruments))
        songs.append(get_input(*read_midi(smf.parse_midi_bytes(data))))
    fp32 = ttr.device_batch_from_songs(songs, 2, 8, bar_cap=[8, 6],
                                       device="cpu")
    bf16 = ttr.device_batch_from_songs(songs, 2, 8, bar_cap=[8, 6],
                                       device="cpu", raster_dtype="bfloat16")
    for name in ttr.Batch._fields:
        a, b = getattr(fp32, name), getattr(bf16, name)
        if name in ("pitched", "unpitched"):
            assert b.dtype == torch.bfloat16
            assert torch.equal(a.to(torch.bfloat16), b)
        else:
            assert torch.equal(a, b), name


def test_cli_dtype_flags(tmp_path, monkeypatch):
    """train-model-torch.py --storage-dtype/--compute-dtype (the JAX CLI's
    choices, train-model.py:50-61): the step runs under the policy, with
    K1's rasters built at the storage dtype, its losses are finite and
    differ from the fp32 run's; a dtype outside the choices is refused."""
    import os
    import sys

    from tests.test_torch_train import TOOLS, _cli, _csv_rows
    sys.path.insert(0, TOOLS)
    from make_corpus import generate_song
    from mst_tpu.io import create_midi, native

    data = tmp_path / "data"
    data.mkdir()
    info, instruments = generate_song(np.random.default_rng(0))
    native.write_midi_file(str(data / "s0.mid"),
                           create_midi(info, *instruments))
    cli = _cli()
    seen = []
    build = ttr.device_batch_from_songs
    monkeypatch.setattr(ttr, "device_batch_from_songs", lambda *a, **k: (
        seen.append(k.get("raster_dtype")), build(*a, **k))[1])

    def run(name, *flags):
        cli.main(["--data", str(data), "--device", "cpu", "--iters", "2",
                  "--csv", str(tmp_path / f"{name}.csv"), "--snapshots",
                  str(tmp_path / name), *flags])
        return _csv_rows(tmp_path / f"{name}.csv")

    fp32 = run("fp32")
    bf16 = run("bf16", "--storage-dtype", "bfloat16", "--compute-dtype",
               "bfloat16")
    # the fp32 run's batches (the prefetch thread may build one ahead),
    # then the bf16 run's
    n32 = seen.index("bfloat16")
    assert n32 >= 2 and set(seen[:n32]) == {"float32"}
    assert set(seen[n32:]) == {"bfloat16"}
    assert len(bf16) == len(fp32) == 2
    assert all(np.isfinite(float(r["total"])) for r in bf16)
    assert bf16 != fp32
    with pytest.raises(SystemExit):
        cli.parse_args(["--storage-dtype", "float16"])
    assert os.path.exists(tmp_path / "bf16.csv")


def test_norms_and_losses_reduce_bf16_inputs_in_fp32():
    """The bf16 tensors that reach ``combine`` (stored activations) and the
    channel losses (the bf16 applier outputs and rasters) are reduced in
    fp32, the masks built after the upcast, as mst_tpu's are
    (mst_tpu/ops/shapes.py:74-79, mst_tpu/ops/losses.py:122-129): the
    results are fp32 and equal mst_tpu's on the same bf16 inputs within
    fp32 reassociation (rtol 1e-5, atol 1e-6)."""
    from mst_tpu.ops import losses as jl
    from mst_tpu.ops import shapes as js
    from mst_torch.ops import losses as tl
    from mst_torch.ops import shapes as ts

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    mask = np.float32([[1, 1, 0], [1, 0, 0]])
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)
    got = ts.combine(tx, axis=1, mask=torch.from_numpy(mask))
    want = js.combine(jx, axis=1, mask=jnp.asarray(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)

    shape = (2, 2, 3, 4, 10, 56, 5)
    pred = rng.random(shape).astype(np.float32)
    target = ((rng.random(shape) > 0.9) * rng.random(shape)).astype(
        np.float32)
    pad = np.ones(shape[:3], np.float32)
    pad[1, 1, 2] = 0.0
    j_args = [jnp.asarray(a, jnp.bfloat16) for a in (pred, target)]
    t_args = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in j_args]
    got = tl.channels_losses(*t_args, pitched=True,
                             pad_mask=torch.from_numpy(pad))
    want = jl.channels_losses(*j_args, pitched=True,
                              pad_mask=jnp.asarray(pad))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-6)
