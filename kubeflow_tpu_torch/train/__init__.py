"""Training of the port: the LM, MLM (BERT) and image (ResNet, ViT, MNIST)
train steps, and checkpoints."""

from kubeflow_tpu_torch.train.trainer import (  # noqa: F401
    AdamW,
    Optimizer,
    Sgd,
    TrainState,
    chunked_next_token_loss,
    create_bert_train_state,
    create_image_train_state,
    create_sharded_state,
    create_train_state,
    create_vit_train_state,
    global_norm,
    make_image_train_step,
    make_lm_train_step,
    make_mlm_train_step,
    make_optimizer,
    make_pipelined_lm_train_step,
    make_sgd,
    masked_lm_loss,
    next_token_loss,
    softmax_cross_entropy,
    state_partition_specs,
    state_shardings,
)
