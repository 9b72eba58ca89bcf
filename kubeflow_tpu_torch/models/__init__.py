"""Models of the port: the decoder LM, the BERT encoder and the ResNet
family."""

from kubeflow_tpu_torch.models.bert import (  # noqa: F401
    Bert,
    BertConfig,
    bert_base,
    bert_large,
    bert_tiny,
    mask_tokens,
)
from kubeflow_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResNetConfig,
    resnet18_thin,
    resnet50,
)
from kubeflow_tpu_torch.models.transformer import (  # noqa: F401
    DenseKVCache,
    PagedKVCache,
    Transformer,
    TransformerConfig,
    tiny_config,
)
