"""PyTorch/CUDA port of the ``kubeflow_tpu`` compute path, for NVIDIA Hopper.

The JAX package (``kubeflow_tpu/``) is the reference: every module here
mirrors a module there by name and is tested against it. This package
imports ``torch``, numpy and yaml, never ``jax`` or ``kubeflow_tpu``.

Layout:

- ``models/transformer.py`` — the decoder LM, with the paged decode cache,
  flash attention and remat;
- ``models/resnet.py`` — the ResNet family, with the fused BN-apply +
  ReLU + 1x1 conv;
- ``models/decode.py`` — prefill chunks, decode steps, the sampler;
- ``models/convert.py`` — JAX param trees / ``params.npz`` and ResNet
  variables → port modules, and back for ResNet;
- ``ops/paged_attention.py`` + ``ops/csrc/paged_attention.cu``,
  ``ops/sampling.py`` + ``ops/csrc/fused_sample.cu``,
  ``ops/flash_attention.py`` + ``ops/csrc/flash_attention.cu`` and
  ``ops/bnconv.py`` + ``ops/csrc/bnconv.cu`` — the CUDA kernels
  (serving; the flash forward, dQ and dK/dV of LM training; the fused
  BN + ReLU + 1x1 conv and its dW of ResNet training), each beside its
  plain PyTorch version;
- ``ops/_build.py`` — builds ``ops/csrc/*.cu`` with ``nvcc`` at first use
  (each build announced to the compile ledger, ``obs/xprof.py``);
- ``ops/autotune.py`` + ``ops/tile_table.json`` — the kernels' tile
  table (Hopper legality; the paged kernel's split);
- ``ops/act_compress.py`` — int8 forward-saved conv inputs (ResNet's
  ``act_compress``);
- ``serving/`` — page allocator, decode engine, model store, HTTP server,
  gRPC service, batch prediction, the model multiplexer;
- ``obs/`` — spans and their push, the request ledger, step telemetry,
  the compile ledger and memory budgets;
- ``k8s/``, ``tuning/`` — object builders, a ConfigMap client, and the
  trial-metrics reporters;
- ``data/`` — the shard loader (a native batcher and its Python twin)
  and the device feed;
- ``train/`` — optimizers, train state, losses, the LM and image train
  steps.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__all__ = ["data", "models", "ops", "serving", "train", "utils"]
