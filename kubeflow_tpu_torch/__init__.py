"""PyTorch/CUDA port of the ``kubeflow_tpu`` compute path, for NVIDIA Hopper.

The JAX package (``kubeflow_tpu/``) is the reference: every module here
mirrors a module there by name and is tested against it. This package
imports ``torch``, numpy and yaml, never ``jax`` or ``kubeflow_tpu``.

Layout (slices: paged LM serving, LM training):

- ``models/transformer.py`` — the decoder LM, with the paged decode cache,
  flash attention and remat;
- ``models/decode.py`` — prefill chunks, decode steps, the sampler;
- ``models/convert.py`` — JAX param trees / ``params.npz`` → port modules;
- ``ops/paged_attention.py`` + ``ops/csrc/paged_attention.cu``,
  ``ops/sampling.py`` + ``ops/csrc/fused_sample.cu`` and
  ``ops/flash_attention.py`` + ``ops/csrc/flash_attention.cu`` — the
  CUDA kernels (serving; the flash forward, dQ and dK/dV of training),
  each beside its plain PyTorch version;
- ``ops/_build.py`` — builds ``ops/csrc/*.cu`` with ``nvcc`` at first use;
- ``serving/`` — page allocator, decode engine, model store, HTTP server;
- ``train/`` — optimizer, train state, losses, the LM train step.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__all__ = ["models", "ops", "serving", "train", "utils"]
