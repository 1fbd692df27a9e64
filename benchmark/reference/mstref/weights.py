"""Flax-layout parameter files -> the reference model's ``state_dict``.

A frozen copy of the port's conversion (Dense kernels transposed, LSTM
``w_ih``/``w_hh`` transposed to nn.LSTM's layout, ``cell``/``fwd`` ->
``_l0``, ``bwd`` -> ``_l0_reverse``), so that the reference reads the raw
weight file itself.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

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



def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Flat ``a/b/c`` fp32 params from an npz export."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
