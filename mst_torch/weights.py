"""Flax parameter trees -> the port's ``state_dict``.

The port's modules carry the flax modules' names, so a leaf's path maps
directly (``a/b/kernel`` -> ``a.b.weight``). The layout rules are those of
mst_tpu/runtime/ref_checkpoint.py:12-24:

- Dense / ConcatDense / DenseParams kernels are (in, out) in flax and
  (out, in) here: transposed. Biases map as they are.
- The Conv1d kernel is (out, in, k) in both: as it is.
- LSTM ``w_ih`` (D, 4H) and ``w_hh`` (H, 4H) transpose to nn.LSTM's
  ``weight_ih_l0`` (4H, D) and ``weight_hh_l0`` (4H, H), gate order
  (i, f, g, o) in both. ``b_ih`` and ``b_hh`` stay two vectors. The flax
  subtree ``cell`` (unidirectional) or ``fwd`` maps to the suffix ``_l0``,
  ``bwd`` to ``_l0_reverse``.

The committed asset ``mst_torch/assets/snapshot_4900.npz`` holds the
trained params of ``snapshots/4900`` as flat ``a/b/c`` keys (written by
tools/export_torch_assets.py); ``load_npz`` reads it.

``train_state_from_flax`` carries a whole mst_tpu train state over — params,
optax Adam moments and count, accumulated gradients and counters — so the
port can continue a run that mst_tpu started.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Mapping

import numpy as np
import torch

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
SNAPSHOT_NPZ = os.path.join(ASSETS, "snapshot_4900.npz")

_LSTM_LEAVES = {"w_ih": "weight_ih", "w_hh": "weight_hh",
                "b_ih": "bias_ih", "b_hh": "bias_hh"}
_LSTM_SUBTREES = {"cell": "_l0", "fwd": "_l0", "bwd": "_l0_reverse"}


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested param dict -> {"a/b/c": ndarray}."""
    out = {}
    for name, value in tree.items():
        key = f"{prefix}/{name}" if prefix else name
        if hasattr(value, "items"):
            out.update(flatten_tree(value, key))
        else:
            out[key] = np.asarray(value)
    return out


def _torch_leaf(path: str, value: np.ndarray):
    """One flax leaf -> (state_dict key, tensor)."""
    *mods, leaf = path.split("/")
    if leaf in _LSTM_LEAVES and mods and mods[-1] in _LSTM_SUBTREES:
        name = _LSTM_LEAVES[leaf] + _LSTM_SUBTREES[mods[-1]]
        mods = mods[:-1]
        if leaf.startswith("w_"):
            value = value.T
    elif leaf == "kernel":
        name = "weight"
        if value.ndim == 2:
            value = value.T
        elif value.ndim != 3:
            raise ValueError(f"{path}: unexpected kernel rank {value.ndim}")
    elif leaf == "bias":
        name = "bias"
    else:
        raise ValueError(f"{path}: unknown parameter leaf {leaf!r}")
    key = ".".join(mods + [name])
    return key, torch.from_numpy(np.array(value, dtype=np.float32,
                                          order="C"))


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax param tree (nested dict of arrays, with or without the top
    ``params`` level) or its flat ``a/b/c`` form -> the port's
    ``state_dict`` for ``StyleTransferModel.load_state_dict``."""
    if "params" in params and hasattr(params["params"], "items"):
        params = params["params"]
    flat = flatten_tree(params) if any(
        hasattr(v, "items") for v in params.values()) else dict(params)
    return dict(_torch_leaf(k, np.asarray(v)) for k, v in flat.items())


def _flat(tree: Mapping) -> Dict[str, np.ndarray]:
    if "params" in tree and hasattr(tree["params"], "items"):
        tree = tree["params"]
    return flatten_tree(tree)


def train_state_from_flax(params: Mapping, mu: Mapping, nu: Mapping,
                          count: int, accum_grads: Mapping, micro_step: int,
                          opt_step: int, config=None, device=None):
    """A port ``TrainState`` (mst_torch.runtime.train) holding an mst_tpu
    ``TrainState`` given as numpy: ``params``, the ``mu``/``nu`` moments and
    ``count`` of optax's ScaleByAdamState (``opt_state[0]``),
    ``accum_grads``, ``micro_step`` and ``opt_step``. Each tree maps leaf
    for leaf by the rules above; Adam's ``exp_avg``/``exp_avg_sq``/``step``
    take mu/nu/count, and the StepLR schedule is stepped ``opt_step`` times,
    as an uninterrupted port run would have stepped it. ``device=None``
    means the GPU and raises without one (``transfer.resolve_device``);
    pass ``"cpu"`` to build the state on the host."""
    from mst_torch.config import Config
    from mst_torch.models import StyleTransferModel
    from mst_torch.runtime.train import create_train_state, prepare_state
    from mst_torch.transfer import resolve_device

    device = resolve_device(device)
    config = Config() if config is None else config
    model = StyleTransferModel(config.model)
    model.load_state_dict(state_dict_from_flax(params))
    state = create_train_state(config, device=device, model=model)
    mu_t, nu_t, acc_t = (dict(_torch_leaf(k, v) for k, v in _flat(t).items())
                         for t in (mu, nu, accum_grads))
    names = [name for name, _ in state.model.named_parameters()]
    saved = state.optimizer.state_dict()
    step = torch.tensor(float(count), dtype=torch.float32)
    saved["state"] = {i: {"step": step.clone(), "exp_avg": mu_t[name],
                          "exp_avg_sq": nu_t[name]}
                      for i, name in enumerate(names)}
    state.optimizer.load_state_dict(saved)
    for name, p in state.model.named_parameters():
        p.grad = acc_t[name].to(p.device)
    with warnings.catch_warnings():
        # stepping the schedule alone: torch warns that no optimizer step ran
        warnings.simplefilter("ignore")
        for _ in range(int(opt_step)):
            state.scheduler.step()
    state.micro_step = int(micro_step)
    state.opt_step = int(opt_step)
    return prepare_state(state)


def load_npz(path: str = SNAPSHOT_NPZ) -> Dict[str, np.ndarray]:
    """Flat ``a/b/c`` fp32 params from an npz export."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
