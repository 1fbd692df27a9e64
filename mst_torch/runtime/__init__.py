"""Training runtime of the port: the train step (``train``), checkpoints
(``checkpoint``), logging and step timing (``metrics``) and matmul-FLOP
accounting (``flops``)."""
from mst_torch.runtime.train import (  # noqa: F401
    Batch, TrainState, batch_from_song, create_train_state, make_train_step,
    make_lr_schedule,
)
