"""Training runtime of the port: the train step (``train``), checkpoints
(``checkpoint``) and logging (``metrics``)."""
