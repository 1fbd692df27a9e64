"""The port's training step as a program (mst_torch.runtime.train,
``make_train_step`` / ``make_multi_train_step``) and ``call_log`` with
``replay_log_flops``, against mst_tpu on the CPU.

On the CPU the step's body runs eagerly; it is the body a card captures.
Most cases run it in two forms: the CPU's (Adam with a float rate and
torch's float64 bias correction) and the card's (``capturable`` Adam with
the step count and the rate as tensors, fp32 bias corrections), which
torch refuses on the CPU unless its list of capturable devices is
widened, as the ``form`` fixture does. Narrow widths, the songs and
parameters of tests/test_torch_train.py. Tolerances:

- against mst_tpu: test_torch_train.py's trajectory tolerances, rtol
  2e-5 and atol 1e-7 on the losses, rtol 1e-5 and atol 1e-4 on the
  parameters after Adam applies; for the batch-2 stacks atol 3e-4 on the
  parameters (measured 2.4e-4 at one element each of
  ``melody_encoder.octave_linear``'s weight and bias, every other element
  within 1e-4): a first Adam update is lr * g / (|g| + eps), so where the
  summed gradient g lies near eps the frameworks' fp32 sums in other
  orders move the parameter by a share of lr = 0.01;
- against the port's own sequential eager steps: bit-equal;
- rates, addresses, host round trips, the CLI's rows and FLOP counts:
  exact.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.optim import adam as torch_adam
from torch.optim import optimizer as torch_optimizer

from mst_tpu import transfer as jt
from mst_tpu.config import ModelConfig as JModelConfig
from mst_tpu.models import StyleTransferModel as JModel
from mst_tpu.runtime import flops as jf
from mst_tpu.runtime import train as jtr
from mst_torch import transfer as tt
from mst_torch import weights
from mst_torch.config import ModelConfig
from mst_torch.models import StyleTransferModel
from mst_torch.ops import grid_kernel
from mst_torch.ops.losses import LossDict
from mst_torch.runtime import flops
from mst_torch.runtime import train as ttr
from tests.test_torch_fused import _HostRoundTrips
from tests.test_torch_model import NARROW, _params_like
from tests.test_torch_train import (  # noqa: F401  (fixtures)
    NO_PERC_SEED, PERC_SEEDS, TOOLS, _cli, _csv_rows, _torch_model,
    model_pair, songs, trajectory)

LOSS_TOL = dict(rtol=2e-5, atol=1e-7)
PARAM_TOL = dict(rtol=1e-5, atol=1e-4)
STACK_PARAM_TOL = dict(rtol=1e-5, atol=3e-4)


def _card_form(monkeypatch):
    """States made from here on take the card's optimizer form on the CPU:
    torch's list of capturable devices widened to hold it."""
    supported = torch_optimizer._get_capturable_supported_devices

    def devices(supports_xla=True):
        return supported(supports_xla) + ["cpu"]

    for module in (torch_adam, torch_optimizer):
        monkeypatch.setattr(module, "_get_capturable_supported_devices",
                            devices)
    monkeypatch.setattr(ttr, "_capturable", lambda device: True)


@pytest.fixture(params=["cpu", "card"])
def form(request, monkeypatch):
    """The optimizer form the state takes: the CPU's, or the card's
    (``capturable`` Adam, rate and step count as tensors) on the CPU."""
    if request.param == "card":
        _card_form(monkeypatch)
    return request.param


def _state(params, config):
    return ttr.create_train_state(config, device="cpu",
                                  model=_torch_model(params, config))


def _check_form(state, form):
    lr = state.optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) == (form == "card")
    assert state.optimizer.param_groups[0]["capturable"] == (form == "card")


def _j_state(params, j_config):
    opt = jtr.make_optimizer(j_config)
    params = jax.tree_util.tree_map(jnp.array, params)   # the step donates
    return jtr.TrainState(
        params=params, opt_state=opt.init(params),
        accum_grads=jax.tree_util.tree_map(jnp.zeros_like, params),
        micro_step=jnp.zeros((), jnp.int32), opt_step=jnp.zeros((), jnp.int32))


def _assert_params(state, j_params, tol=PARAM_TOL):
    want = weights.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, j_params))
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   err_msg=name, **tol)


def _assert_same_state(a, b):
    """Bit-equal parameters, gradient buffers and Adam state."""
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(p.grad, q.grad), name
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k], sb[k]), (name, k)
    assert (a.micro_step, a.opt_step) == (b.micro_step, b.opt_step)


# ------------------------------------------------------------ trajectory

def test_trajectory_matches_mst_tpu(trajectory, model_pair, form):
    """4 micro-steps, iter_size 2, through make_train_step against
    mst_tpu's make_train_step (the ``trajectory`` fixture): the losses of
    every step and the parameters after the second apply."""
    _, params, _, t_config = model_pair
    t_batches, want, _, final = trajectory
    state = _state(params, t_config)
    _check_form(state, form)
    step = ttr.make_train_step(t_config, True)
    got = np.stack([step(state, b)[1].numpy() for b in t_batches])
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert (state.micro_step, state.opt_step) == (4, 2)
    _assert_params(state, final)


# ---------------------------------------------------------------- stacks

def _stack_songs(k):
    """The K micro-steps of a stack: two songs each, with bar caps."""
    return [([PERC_SEEDS[i % 3], PERC_SEEDS[(i + 1) % 3]], [8 - i, 5 + i])
            for i in range(k)]


def _flat(groups, b_major):
    """The K*B songs and caps of a stack in its layout."""
    if b_major:
        return ([g[0][b] for b in range(2) for g in groups],
                [g[1][b] for b in range(2) for g in groups])
    return [s for g in groups for s in g[0]], [c for g in groups
                                               for c in g[1]]


_J_STACKS = {}


def _j_stack(songs, model_pair, k, b_major):
    """mst_tpu's make_multi_train_step on the stack: (losses, params)."""
    if (k, b_major) not in _J_STACKS:
        j_model, params, j_config, _ = model_pair
        seeds, caps = _flat(_stack_songs(k), b_major)
        kbatch = jtr.device_batch_from_songs([songs[s][0] for s in seeds], 2,
                                             8, bar_cap=caps)
        multi = jtr.make_multi_train_step(j_model, j_config, True, k,
                                          b_major=b_major)
        state, vecs = multi(_j_state(params, j_config), kbatch)
        _J_STACKS[k, b_major] = (np.asarray(vecs), jax.tree_util.tree_map(
            np.asarray, state.params))
    return _J_STACKS[k, b_major]


@pytest.mark.parametrize("b_major", [False, True], ids=["k_major", "b_major"])
@pytest.mark.parametrize("k", [2, 3])
def test_stack_matches_mst_tpu_and_sequential_steps(songs, model_pair, form,
                                                    k, b_major):
    """A K-step stack of batch-2 micro-steps, iter_size 2 (one apply),
    laid out ``k*B + b`` or ``b*K + k``: against mst_tpu's
    make_multi_train_step (tests/test_multi_step.py's pairing on the
    port), and bit-equal to K calls of the port's make_train_step."""
    _, params, _, t_config = model_pair
    seeds, caps = _flat(_stack_songs(k), b_major)
    kbatch = ttr.device_batch_from_songs([songs[s][1] for s in seeds], 2, 8,
                                         bar_cap=caps, device="cpu")
    stacked = _state(params, t_config)
    _check_form(stacked, form)
    multi = ttr.make_multi_train_step(t_config, True, k, b_major=b_major)
    _, got = multi(stacked, kbatch)
    want, j_params = _j_stack(songs, model_pair, k, b_major)
    np.testing.assert_allclose(got.numpy(), want, **LOSS_TOL)
    _assert_params(stacked, j_params, STACK_PARAM_TOL)

    single = _state(params, t_config)
    step = ttr.make_train_step(t_config, True)
    rows = []
    for group_seeds, group_caps in _stack_songs(k):
        batch = ttr.device_batch_from_songs(
            [songs[s][1] for s in group_seeds], 2, 8, bar_cap=group_caps,
            device="cpu")
        rows.append(step(single, batch)[1])
    assert torch.equal(got, torch.stack(rows))
    _assert_same_state(stacked, single)


def test_stack_crossing_a_decay_boundary_takes_each_rate(songs, model_pair,
                                                         form):
    """``lr_decay_every=1``: a 4-step stack applies Adam twice, at
    optimizer steps 0 and 1, each at the rate make_lr_schedule gives for
    its step (in fp32 in the card's form); the host's scheduler is then at
    step 2."""
    import dataclasses

    _, params, _, t_config = model_pair
    config = dataclasses.replace(t_config, train=dataclasses.replace(
        t_config.train, lr_decay_every=1))
    schedule = ttr.make_lr_schedule(config)
    state = _state(params, config)
    seen = []

    def record(optimizer, args, kwargs):
        lr = optimizer.param_groups[0]["lr"]
        seen.append(lr.item() if isinstance(lr, torch.Tensor) else lr)

    state.optimizer.register_step_pre_hook(record)
    kbatch = ttr.device_batch_from_songs(
        [songs[s][1] for s in PERC_SEEDS + PERC_SEEDS[:1]], 2, 8,
        bar_cap=[8, 6, 7, 5], device="cpu")
    ttr.make_multi_train_step(config, True, 4)(state, kbatch)
    want = [schedule(0), schedule(1)]
    if form == "card":
        want = [float(np.float32(r)) for r in want]
    assert seen == want and schedule(1) < schedule(0)
    assert (state.micro_step, state.opt_step) == (4, 2)
    assert state.scheduler.last_epoch == 2
    assert float(state.optimizer.param_groups[0]["lr"]) == pytest.approx(
        schedule(2), rel=1e-7)


# ------------------------------------------------------ static addresses

def _addresses(state):
    out = {}
    for name, p in state.model.named_parameters():
        adam = state.optimizer.state[p]
        out[name] = (p.data_ptr(), p.grad.data_ptr(),
                     adam["exp_avg"].data_ptr(),
                     adam["exp_avg_sq"].data_ptr(), adam["step"].data_ptr())
    lr = state.optimizer.param_groups[0]["lr"]
    if isinstance(lr, torch.Tensor):
        out["lr"] = lr.data_ptr()
    return out


def test_state_tensors_keep_their_addresses(songs, model_pair, form):
    """Three bodies, iter_size 3 (a percussion song, a song without, a
    percussion song that applies Adam): every parameter, gradient buffer
    and Adam state tensor (and the rate tensor in the card's form) stays at
    its address, as a replayed graph needs. The song without percussion
    leaves the unpitched branch's gradient buffers as they were; the apply
    zeroes every buffer in place."""
    import dataclasses

    _, params, _, t_config = model_pair
    config = dataclasses.replace(t_config, train=dataclasses.replace(
        t_config.train, iter_size=3))
    state = _state(params, config)
    before = _addresses(state)

    def batch(seed):
        return ttr.device_batch_from_songs([songs[seed][1]], 2, 8,
                                           bar_cap=8, device="cpu")

    perc, no_perc = batch(PERC_SEEDS[0]), batch(NO_PERC_SEED)
    assert no_perc.unpitched is None
    ttr.make_train_step(config, True)(state, perc)
    unpitched = {n: p.grad.clone() for n, p in
                 state.model.named_parameters()
                 if n.startswith(("unpitched_channels", "unpitched_rhythm",
                                  "unpitched_style"))}
    assert unpitched and all(g.any() for g in unpitched.values())
    ttr.make_train_step(config, False)(state, no_perc)
    grads = dict(state.model.named_parameters())
    for name, g in unpitched.items():
        assert torch.equal(grads[name].grad, g), name
    assert _addresses(state) == before
    ttr.make_train_step(config, True)(state, perc)
    assert (state.micro_step, state.opt_step) == (3, 1)
    assert _addresses(state) == before
    assert not any(p.grad.any() for p in state.model.parameters())


# ------------------------------------------------------ host round trips

@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_body_makes_no_host_round_trip(songs, model_pair, remat,
                                       monkeypatch):
    """The body of a 2-step stack in the card's form (forward, backward,
    the rate copy, capturable Adam and the in-place zeroing) runs no op
    that waits for a value on the host or copies a host tensor in: either
    would synchronise on the card, and a capture refuses it. The kernels'
    plain versions are left out (on the card the kernels run)."""
    import dataclasses

    _card_form(monkeypatch)
    mode = _HostRoundTrips()

    def outside(plain):
        def run(*args, **kwargs):
            mode.plain += 1
            try:
                return plain(*args, **kwargs)
            finally:
                mode.plain -= 1
        return run

    for name in ("grid_tail_plain", "grid_tail_bwd_plain"):
        monkeypatch.setattr(grid_kernel, name,
                            outside(getattr(grid_kernel, name)))
    _, params, _, t_config = model_pair
    config = dataclasses.replace(t_config, train=dataclasses.replace(
        t_config.train, remat=remat))
    state = _state(params, config)
    kbatch = ttr.device_batch_from_songs(
        [songs[s][1] for s in PERC_SEEDS[:2]], 2, 8, bar_cap=[8, 6],
        device="cpu")
    body = ttr._make_body(config, True, 2)
    rates = torch.tensor([0.01], dtype=torch.float32)
    with mode:
        torch.tensor([1.0])                  # the check sees what it seeks
        assert mode.found == ["aten.lift_fresh.default"]
        mode.found.clear()
        losses = body(state, tuple(kbatch), rates, pattern=(False, True))
    assert mode.found == []
    assert losses.shape == (2, len(LossDict._fields))
    assert int(state.optimizer.state[next(state.model.parameters())][
        "step"]) == 1


# ------------------------------------------------------------------ mesh

@pytest.mark.parametrize("k", [1, 2])
def test_capture_over_a_mesh_raises(model_pair, k):
    """A captured step over a process mesh is refused, naming why; the
    same step with ``capture=False`` is made."""
    from types import SimpleNamespace

    _, _, _, t_config = model_pair
    mesh = SimpleNamespace(group=None, data_group=None)

    def make(**kwargs):
        if k == 1:
            return ttr.make_train_step(t_config, True, **kwargs)
        return ttr.make_multi_train_step(t_config, True, k, **kwargs)

    with pytest.raises(ValueError, match="gloo.*NCCL"):
        make(mesh=mesh)
    with pytest.raises(ValueError, match="gloo"):
        make(mesh=mesh, capture=True)
    assert callable(make(mesh=mesh, capture=False))


# ------------------------------------------------------------------- CLI

def test_cli_rows_with_and_without_capture(tmp_path):
    """train-model-torch.py --device cpu on 3 synthetic songs, 5
    iterations, with the default (capture) and with --no-capture: the
    same CSV rows, exactly (the CPU runs the step eagerly either way)."""
    sys.path.insert(0, TOOLS)
    from make_corpus import generate_song
    from mst_tpu.io import create_midi, native

    data = tmp_path / "data"
    data.mkdir()
    for seed in (0, 245, NO_PERC_SEED):
        info, instruments = generate_song(np.random.default_rng(seed))
        native.write_midi_file(str(data / f"s{seed}.mid"),
                               create_midi(info, *instruments))
    cli = _cli()
    rows = {}
    for name, extra in (("captured", []), ("eager", ["--no-capture"])):
        state = cli.main(["--data", str(data), "--device", "cpu", "--iters",
                          "5", "--csv", str(tmp_path / f"{name}.csv"),
                          "--snapshots", str(tmp_path / name), "--seed",
                          "3"] + extra)
        assert (state.micro_step, state.opt_step) == (5, 2)
        rows[name] = _csv_rows(tmp_path / f"{name}.csv")
    assert len(rows["captured"]) == 5
    assert rows["captured"] == rows["eager"]


# ------------------------------------------------------ replay_log_flops

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replay_log_flops_of_a_request(tmp_path, dtype):
    """The narrow request of tests/test_torch_flops.py (two compositions
    with percussion in one style, one ``transfer_fused`` program) with
    ``call_log`` on: ``replay_log_flops`` of the log equals
    ``count_matmul_flops`` of the same request uncaptured, and mst_tpu's
    ``replay_log_flops`` of its own log (the request pins no difference);
    replaying logs nothing more."""
    from tests.test_torch_transfer import _write_songs

    j_model = JModel(JModelConfig(**NARROW, compute_dtype=dtype))
    params = _params_like(
        j_model.init, jax.random.PRNGKey(1), jnp.array([[1.0, 0.0]]),
        jnp.array([120.0]), jnp.zeros((1, 1, 2, 4, 10, 56, 5)),
        jnp.zeros((1, 1, 51)).at[0, 0, 0].set(1.0),
        jnp.zeros((1, 1, 2, 4, 10, 47, 2)))
    params = jt.sparsify_velocity_bias(dict(params))
    j_bundle = jt.ModelBundle(model=j_model, params=params)
    model = StyleTransferModel(ModelConfig(**NARROW, compute_dtype=dtype))
    model.load_state_dict(weights.state_dict_from_flax(params), strict=True)
    t_bundle = tt.ModelBundle(model=model, device="cpu", capture=False)
    comps = _write_songs(tmp_path, (0, 245))
    styles = _write_songs(tmp_path, (235,))

    jt.transfer_styles(j_bundle, comps, styles, str(tmp_path / "warm"))
    j_bundle.call_log = []
    jt.transfer_styles(j_bundle, comps, styles, str(tmp_path / "jax"))
    want = jf.replay_log_flops(j_bundle._raw, j_bundle.call_log)

    assert t_bundle.call_log is None
    tt.transfer_styles(t_bundle, comps, styles, str(tmp_path / "warm_t"))
    counted = flops.count_matmul_flops(tt.transfer_styles, t_bundle, comps,
                                       styles, str(tmp_path / "counted"))
    t_bundle.call_log = log = []
    tt.transfer_styles(t_bundle, comps, styles, str(tmp_path / "logged"))
    assert [key for key, *_ in log] == [
        key for key, _, _ in j_bundle.call_log]
    assert [(key.split(":")[0], shard) for key, _, _, shard in log] == \
        [("transfer_fused", 0)]
    got = flops.replay_log_flops(t_bundle, log)
    assert len(log) == 1
    assert got > 0
    assert got == counted == want
    assert flops.replay_log_flops(t_bundle, log * 3) == 3 * got


# ------------------------------------------------------ stateful programs

def test_stateful_program_runs_once_then_a_failed_capture_raises(
        monkeypatch):
    """A stateful program's first call is the real call: its body runs
    once, on the side stream, and then the capture only records it. A
    capture that fails raises after that one run; nothing runs the body
    again in the graph's place, and no graph is kept. The card is faked
    as in tests/test_torch_rules.py: stand-in streams and pool, static
    inputs on the CPU, and ``torch.cuda.graph`` refusing the capture."""
    import contextlib

    from mst_torch.runtime import programs

    runs = []

    class Stream:
        def __init__(self, *args, **kwargs):
            pass

        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def side(stream):
        runs.append("side stream")
        yield

    def refuse(*args, **kwargs):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream", side)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    monkeypatch.setattr(programs.Programs, "_static_input",
                        lambda self, leaf: leaf.clone())
    state = torch.zeros(3)

    def step(x, *, scale):
        assert torch.is_grad_enabled()
        state.add_(x * scale)
        return state * 2

    progs = programs.Programs("cuda")
    with pytest.raises(RuntimeError, match="capture failed"):
        progs.run("step", step, (torch.ones(3),), {"scale": 2.0},
                  capture=True, stateful=True)
    assert runs == ["side stream"]
    assert state.tolist() == [2.0, 2.0, 2.0]
    assert progs.graphs == {}


# --------------------------------------------------------------- restore

@pytest.mark.parametrize("saved_by", ["cpu", "card"])
def test_restore_takes_the_state_form_and_drops_programs(songs, model_pair,
                                                         saved_by,
                                                         monkeypatch):
    """A checkpoint written by either optimizer form (the card's before
    this form existed held a float rate, ``capturable=False`` and its step
    count on the host) restores into a state of the other form: the
    state keeps its own form (rate, ``capturable``, the step count's
    place), takes the saved values, drops its captured programs, and
    trains on."""
    from mst_torch.runtime.checkpoint import (load_state_dict_into,
                                              state_dict_of)

    _, params, _, t_config = model_pair
    batch = ttr.device_batch_from_songs([songs[PERC_SEEDS[0]][1]], 2, 8,
                                        bar_cap=8, device="cpu")
    step = ttr.make_train_step(t_config, True)
    with monkeypatch.context() as patch:
        if saved_by == "card":
            _card_form(patch)
        source = _state(params, t_config)
        for _ in range(2):
            step(source, batch)
        saved = state_dict_of(source)
    if saved_by == "cpu":
        _card_form(monkeypatch)
    target = _state(params, t_config)
    form = "cpu" if saved_by == "card" else "card"
    target.programs = "captured graphs"
    load_state_dict_into(target, saved)
    _check_form(target, form)
    assert target.programs is None
    assert float(target.optimizer.param_groups[0]["lr"]) == pytest.approx(
        ttr.make_lr_schedule(t_config)(1), rel=1e-7)
    for (name, p), q in zip(target.model.named_parameters(),
                            source.model.parameters()):
        assert torch.equal(p, q), name
        adam = target.optimizer.state[p]
        assert adam["step"].dtype == torch.float32 and int(adam["step"]) == 1
        assert torch.equal(adam["exp_avg"], source.optimizer.state[q][
            "exp_avg"]), name
    step(target, batch)
    assert (target.micro_step, target.opt_step) == (3, 1)
