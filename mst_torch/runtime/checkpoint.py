"""Checkpoint/resume with ``torch.save``: model, optimizer and schedule
state, the accumulated gradients, the step counters, and the data cursor.

Counterpart of mst_tpu/runtime/checkpoint.py (which uses orbax). The
reference pickles the whole model every 100 iterations with no optimizer
state and no resume path (train-model.py:156-160); here a checkpoint
carries the full train state so training resumes exactly. One file per
step, ``<directory>/ckpt_<step>.pt``, written atomically, with the data
iterator's position beside it in ``cursor_<step>.json``; the newest
``max_to_keep`` steps are kept.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Optional

import torch

from mst_torch.runtime.train import TrainState, prepare_state

_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")


def state_dict_of(state: TrainState) -> dict:
    """Everything a resume needs, as tensors and plain Python values. A
    parameter without an accumulated gradient saves zeros (the same sum)."""
    return {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "accum_grads": {name: (p.grad if p.grad is not None
                               else torch.zeros_like(p)).detach().clone()
                        for name, p in state.model.named_parameters()},
        "micro_step": int(state.micro_step),
        "opt_step": int(state.opt_step),
    }


def _load_step_lr(state: TrainState, saved: dict, opt_step: int) -> None:
    """Take a ``StepLR`` state, as older checkpoints hold it, into the
    state's ``LambdaLR``: its step count, which must equal ``opt_step``,
    and each param group's rate from the schedule at that step, so the
    next ``apply_updates`` uses the rate an uninterrupted run would. The
    saved decay must be the one the schedule follows."""
    scheduler = state.scheduler
    last = int(saved["last_epoch"])
    if last != opt_step:
        raise ValueError(f"StepLR state at step {last}, checkpoint at "
                         f"optimizer step {opt_step}")
    step_size, gamma = int(saved["step_size"]), float(saved["gamma"])
    for factor in scheduler.lr_lambdas:
        for k in (0, step_size - 1, step_size, last):
            if not math.isclose(factor(k), gamma ** (k // step_size),
                                rel_tol=1e-9):
                raise ValueError(f"StepLR({step_size}, {gamma}) state: the "
                                 f"schedule in force decays otherwise")
    scheduler.base_lrs = list(saved["base_lrs"])
    scheduler.last_epoch = last
    scheduler._step_count = int(saved.get("_step_count", last + 1))
    rates = [base * factor(last) for base, factor
             in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, rate in zip(state.optimizer.param_groups, rates):
        group["lr"] = rate
    scheduler._last_lr = rates


def load_state_dict_into(state: TrainState, saved: dict) -> TrainState:
    """Load ``state_dict_of``'s output into ``state`` (in place, on the
    state's devices) and return it. A scheduler state is the ``LambdaLR``'s
    or the ``StepLR``'s of older checkpoints (``_load_step_lr``); any other
    raises. The optimizer takes the form of the state's device whatever
    form wrote the checkpoint (``prepare_state``), and the state's
    captured step programs are dropped: they read the tensors this
    replaces."""
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    scheduler = saved["scheduler"]
    if "lr_lambdas" in scheduler:
        state.scheduler.load_state_dict(scheduler)
    elif {"step_size", "gamma", "last_epoch", "base_lrs"} <= set(scheduler):
        _load_step_lr(state, scheduler, int(saved["opt_step"]))
    else:
        raise ValueError(f"unknown scheduler state, keys "
                         f"{sorted(scheduler)}")
    for name, p in state.model.named_parameters():
        p.grad = saved["accum_grads"][name].to(p.device, p.dtype).clone()
    state.micro_step = int(saved["micro_step"])
    state.opt_step = int(saved["opt_step"])
    return prepare_state(state)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def _cursor_path(self, step: int) -> str:
        return os.path.join(self.directory, f"cursor_{step}.json")

    def steps(self):
        """Saved steps, ascending."""
        found = (_CKPT.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: TrainState,
             cursor: Optional[int] = None) -> None:
        tmp = f"{self._path(step)}.{os.getpid()}.tmp"
        torch.save(state_dict_of(state), tmp)
        os.replace(tmp, self._path(step))
        if cursor is not None:
            # data-iterator position alongside the weights, so --resume
            # continues the exact song sequence of an uninterrupted run
            with open(self._cursor_path(step), "w") as fh:
                json.dump({"cursor": int(cursor)}, fh)
        for old in self.steps()[:-self.max_to_keep]:
            for path in (self._path(old), self._cursor_path(old)):
                if os.path.exists(path):
                    os.remove(path)

    def load_cursor(self, step: int) -> Optional[int]:
        try:
            with open(self._cursor_path(step)) as fh:
                return int(json.load(fh)["cursor"])
        except (OSError, ValueError, KeyError):
            return None

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def load(self, step: Optional[int] = None) -> dict:
        """The saved dict of ``step`` (default the latest), on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load a saved step (default the latest) into ``state``."""
        return load_state_dict_into(state, self.load(step))


def load_trained_params(directory: str):
    """``(model state_dict, step)`` of the latest checkpoint under
    ``directory``, or ``(None, None)`` when it holds none."""
    if not os.path.isdir(directory):
        return None, None
    mgr = CheckpointManager(directory)
    step = mgr.latest_step()
    if step is None:
        return None, None
    return mgr.load(step)["model"], step
