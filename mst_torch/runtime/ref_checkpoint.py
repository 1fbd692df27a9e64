"""Import the reference's torch checkpoints into the port's state dict.

The reference pickles its whole torch model every 100 iterations
(``torch.save(model, snapshots/{i}.pkl)``, train-model.py:156-160). The
port's modules carry the reference's module and parameter names and
layouts (``nn.Linear`` (out, in), ``nn.Conv1d`` (out, in, k), ``nn.LSTM``'s
``weight_ih_l0``/``_reverse`` in gate order (i, f, g, o)), so a reference
state dict maps onto ``StyleTransferModel.state_dict()`` name for name,
without going through a flax tree (mst_tpu/runtime/ref_checkpoint.py:12-130
maps it onto flax). The one difference: the reference wraps some
submodules in ``Distributed`` (a shape adapter, utils/pytorch.py:28-51),
which puts ``.module`` before the leaf's name; both variants are tried.
"""

from __future__ import annotations

import sys
from typing import Dict, Mapping

import numpy as np
import torch

from mst_torch.config import ModelConfig
from mst_torch.models import StyleTransferModel


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return torch.from_numpy(np.array(value, dtype=np.float32, order="C"))


def state_dict_from_reference(state_dict: Mapping[str, object],
                              config: ModelConfig = ModelConfig()
                              ) -> Dict[str, torch.Tensor]:
    """The port's state dict (fp32, on the CPU) for a ``StyleTransferModel
    (config)`` from a reference model's ``state_dict()``. Raises
    ``KeyError`` when a parameter of the port has no reference counterpart,
    ``ValueError`` on a shape mismatch or when a reference parameter is
    left unused."""
    target = StyleTransferModel(config).state_dict()
    used = set()
    out = {}
    for name, like in target.items():
        prefix, leaf = name.rsplit(".", 1)
        candidates = (name, f"{prefix}.module.{leaf}")
        key = next((k for k in candidates if k in state_dict), None)
        if key is None:
            raise KeyError(f"no reference parameter among {candidates}")
        used.add(key)
        value = _as_tensor(state_dict[key])
        if tuple(value.shape) != tuple(like.shape):
            raise ValueError(f"{key}: reference shape {tuple(value.shape)} "
                             f"!= port {tuple(like.shape)}")
        out[name] = value
    unused = set(state_dict) - used
    if unused:
        raise ValueError(f"reference parameters with no port counterpart: "
                         f"{sorted(unused)}")
    return out


def load_reference_snapshot(path: str, reference_root: str,
                            config: ModelConfig = ModelConfig()
                            ) -> Dict[str, torch.Tensor]:
    """Load a reference ``snapshots/{i}.pkl`` (a whole-model torch pickle,
    train-model.py:156-160) and map it to the port's state dict.
    ``reference_root`` must hold the reference's ``style`` package: a
    whole-model pickle can only be read with its defining modules
    importable. Only load pickles of a trusted reference run: unpickling
    runs code."""
    if reference_root not in sys.path:
        sys.path.insert(0, reference_root)
    model = torch.load(path, map_location="cpu", weights_only=False)
    return state_dict_from_reference(model.state_dict(), config)
