"""Vision Transformer: image classification on the shared encoder blocks.

PyTorch port of ``kubeflow_tpu/models/vit.py``: a non-overlapping patch
convolution (with a bias) as the stem, the patches flattened in raster
order (flax's NHWC reshape: row by row, then column), RoPE over the
patch index, the LM's ``Block`` stack with ``causal=False`` and dense
attention (the reference's ``TransformerConfig`` default), a final
RMSNorm, a mean pool over the patches and an f32 ``Dense`` head.

Parameters keep the reference's names and layouts: ``patch_embed.kernel``
``(p, p, C, D)`` (flax's HWIO, moved to torch's OIHW at the call),
``patch_embed.bias``, ``blocks.{i}`` as in ``models/transformer.py``,
``final_norm.scale`` and ``head.kernel`` ``(D, classes)``, so weights
carry across through ``models/convert.py`` in either layer layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.resnet import Dense
from kubeflow_tpu_torch.models.transformer import (
    Block,
    RMSNorm,
    TransformerConfig,
    _compute,
    rope_tables,
    run_blocks,
    torch_dtype,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """The reference's fields and defaults (ViT-B/16 at 224²);
    ``scan_layers`` selects the JAX param layout only."""

    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    scan_layers: bool = True

    def __post_init__(self) -> None:
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))
        object.__setattr__(self, "param_dtype",
                           torch_dtype(self.param_dtype))

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def encoder_config(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=1,  # unused: the stem is a patch conv, not a table
            d_model=self.d_model,
            n_layers=self.n_layers,
            n_heads=self.n_heads,
            n_kv_heads=self.n_heads,
            d_ff=self.d_ff,
            max_seq_len=self.n_patches,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            remat=self.remat,
            scan_layers=self.scan_layers,
            causal=False,  # every patch attends to every patch
        )


def vit_base(num_classes: int = 1000) -> ViTConfig:
    return ViTConfig(num_classes=num_classes)


def vit_large(num_classes: int = 1000) -> ViTConfig:
    return ViTConfig(num_classes=num_classes, d_model=1024, n_layers=24,
                     n_heads=16, d_ff=4096)


def vit_tiny(num_classes: int = 10) -> ViTConfig:
    """Test-sized config."""
    return ViTConfig(image_size=32, patch_size=8, num_classes=num_classes,
                     d_model=64, n_layers=2, n_heads=4, d_ff=128,
                     remat=False, scan_layers=False)


class PatchEmbed(nn.Module):
    """flax ``nn.Conv(D, (p, p), strides=p, padding="VALID")`` with a
    bias; the kernel stored HWIO."""

    def __init__(self, c: ViTConfig, in_channels: int = 3) -> None:
        super().__init__()
        p = c.patch_size
        self.patch = p
        self.kernel = nn.Parameter(torch.empty(p, p, in_channels, c.d_model,
                                               dtype=c.param_dtype))
        self.bias = nn.Parameter(torch.empty(c.d_model, dtype=c.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, C)`` in the compute dtype → ``(B, H/p, W/p, D)``."""
        w = _compute(self.kernel, x.dtype).permute(3, 2, 0, 1)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, _compute(self.bias, x.dtype),
                     stride=self.patch)
        return y.permute(0, 2, 3, 1)


class ViT(nn.Module):
    """``forward(images (B, H, W, C), train=True)`` → logits ``(B,
    num_classes)`` f32. ``train`` is accepted for the image train
    step's call and ignored: the ViT has no train-only state."""

    def __init__(self, config: ViTConfig, in_channels: int = 3) -> None:
        super().__init__()
        ec = config.encoder_config()
        ec.validate()
        self.config = config
        self._rope = (ec.head_dim, ec.rope_theta)
        self.patch_embed = PatchEmbed(config, in_channels)
        self.blocks = nn.ModuleList(Block(ec) for _ in range(config.n_layers))
        self.final_norm = RMSNorm(config.d_model,
                                  param_dtype=config.param_dtype)
        self.head = Dense(config.d_model, config.num_classes,
                          config.param_dtype)

    def forward(self, images: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        del train
        c = self.config
        B, H, W, _ = images.shape
        if H != c.image_size or W != c.image_size:
            raise ValueError(f"expected {c.image_size}² input, got {H}x{W}")
        x = self.patch_embed(images.to(c.dtype))
        x = x.reshape(B, -1, c.d_model)  # (B, N, D), raster order
        sin, cos = rope_tables(x.shape[1], *self._rope, images.device)
        x = run_blocks(self.blocks, x, sin, cos, remat=c.remat)
        x = self.final_norm(x)
        # jnp.mean over bf16 sums in f32 and rounds the mean back
        return self.head(x.float().mean(dim=1).to(x.dtype))
