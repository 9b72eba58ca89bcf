"""Models of the port: the decoder LM, the BERT encoder, the ViT, the
ResNet family and the MNIST CNN."""

from kubeflow_tpu_torch.models.bert import (  # noqa: F401
    Bert,
    BertConfig,
    bert_base,
    bert_large,
    bert_tiny,
    mask_tokens,
)
from kubeflow_tpu_torch.models.mnist import MnistCnn  # noqa: F401
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
from kubeflow_tpu_torch.models.vit import (  # noqa: F401
    ViT,
    ViTConfig,
    vit_base,
    vit_large,
    vit_tiny,
)
