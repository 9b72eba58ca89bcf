"""Models of the port: the decoder LM and the ResNet family."""

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
