"""Training of the port (second slice: the LM train step)."""

from kubeflow_tpu_torch.train.trainer import (  # noqa: F401
    Optimizer,
    TrainState,
    chunked_next_token_loss,
    create_train_state,
    global_norm,
    make_lm_train_step,
    make_optimizer,
    next_token_loss,
)
