"""Multi-process multislice workload: the ``dcn`` mesh across real ranks.

PyTorch port of ``kubeflow_tpu/testing/multislice_check.py``. Each
process is one rank of a slice (the TpuJob operator's ``slices: N``
deployment: per-pod ``MEGASCALE_SLICE_ID``/``MEGASCALE_NUM_SLICES`` and
the coordinator env contract). It joins the process group, builds
``parallel/distributed.py:multislice_mesh(penv, tp=...)`` (ranks are
slice-major, as the operator assigns them), and runs 2 LM train steps at
the reference's tiny config, whose gradient average crosses the slices.

The model's weights and the tokens come from numpy seeds, the same on
every rank, so the JAX package's ``make_lm_train_step`` on the same
inputs is the oracle whatever the mesh. The batch is the reference's 8
rows (its ``2·dcn·dp`` at 2 slices of dp 2 × tp 2). Prints one JSON line
with the per-step losses, as the reference does; the harness asserts
that every rank agrees and that the losses match the oracle.

``python -m kubeflow_tpu_torch.testing.multislice_check [--device cpu]
[--tp 2]`` in each rank of a ``run_multiprocess`` gang; on the card each
rank takes ``cuda:(rank % device count)`` and NCCL.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# the reference's tiny config and optimizer
CONFIG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=64, max_seq_len=32, dtype="float32",
              remat=False)
OPT = dict(learning_rate=1e-3, warmup_steps=1, decay_steps=10)
BATCH, SEQ, STEPS = 8, 16, 2
WEIGHT_SEED, TOKEN_SEED = 0, 7


def tokens(vocab: int = CONFIG["vocab_size"]) -> np.ndarray:
    """The global batch every rank (and the oracle) trains on."""
    return np.random.default_rng(TOKEN_SEED).integers(
        0, vocab, (BATCH, SEQ)).astype(np.int32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--tp", type=int, default=2)
    args = p.parse_args(argv)

    import torch
    import torch.distributed as tdist

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.parallel import distributed as dist
    from kubeflow_tpu_torch.parallel import mesh as pmesh
    from kubeflow_tpu_torch.train import (
        create_sharded_state,
        make_lm_train_step,
        make_optimizer,
    )
    from kubeflow_tpu_torch.utils.device import resolve_device

    penv = dist.from_env()
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda",
                              penv.process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.initialize(penv, backend="nccl" if device.type == "cuda"
                    else "gloo")
    mesh = dist.multislice_mesh(penv, tp=args.tp, device_type=device.type)
    sizes = {a: pmesh.axis_size(mesh, a) for a in pmesh.MESH_AXES}

    config = TransformerConfig(**CONFIG)
    state, _ = create_sharded_state(
        config, convert.random_params(config, WEIGHT_SEED),
        make_optimizer(**OPT), mesh, device=device)
    step = make_lm_train_step(mesh)
    batch = tokens(config.vocab_size)
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        # the loss is averaged over the data axes: every rank holds it
        losses.append(float(metrics["loss"]))
    ok = all(loss == loss for loss in losses)  # NaN guard
    print(json.dumps({
        "process_id": penv.process_id,
        "slice_id": penv.slice_id,
        "processes": tdist.get_world_size(),
        "devices": tdist.get_world_size(),
        "mesh": sizes,
        "losses": [round(loss, 6) for loss in losses],
        "ok": ok,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    rc = main()
    import torch.distributed as tdist

    tdist.destroy_process_group()
    sys.exit(rc)
