"""Models of the port (first slice: the decoder LM)."""

from kubeflow_tpu_torch.models.transformer import (  # noqa: F401
    PagedKVCache,
    Transformer,
    TransformerConfig,
    tiny_config,
)
