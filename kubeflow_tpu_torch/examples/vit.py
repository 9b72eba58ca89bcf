"""ViT image-classification training job.

PyTorch port of ``kubeflow_tpu/examples/vit.py``:
``python -m kubeflow_tpu_torch.examples.vit --steps 100`` trains ViT-B/16
(224², d_model 768, 12 layers, 12 heads, d_ff 3072, bf16 compute over
f32 parameters, remat, dense attention) on one synthetic batch of 64
with the image train step and ``make_optimizer(3e-4)``. One untimed
step runs first; then one JSON metrics line every ``--log-every`` steps
and a final line report images/s, which ``main`` returns. Same flags
and defaults as the reference, plus ``--device`` (CUDA by default).
Across processes the mesh is ``dp × tp`` (``--tp``, default 1 here
where the reference picks ``auto_mesh_config``'s): the ViT is built
over it (each rank its block of the blocks' heads and MLP, as the
reference's ``--tp``), the batch is ``per_device_batch × dp`` rows,
every rank makes the same global batch and trains on its data rank's
rows, and rank 0 alone logs. The weights start from
``random_vit_params(config, 0)``.
"""

from __future__ import annotations

import argparse
import time

import torch

from kubeflow_tpu_torch.examples.common import launcher_init, rank_logger
from kubeflow_tpu_torch.models.convert import random_vit_params
from kubeflow_tpu_torch.models.vit import ViTConfig
from kubeflow_tpu_torch.parallel.mesh import axis_size, data_parallel_size
from kubeflow_tpu_torch.train import (
    create_vit_train_state,
    make_image_train_step,
    make_optimizer,
)
from kubeflow_tpu_torch.utils.profiler import StepProfiler


def main(argv=None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--per-device-batch", type=int, default=64)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--patch-size", type=int, default=16)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--d-model", type=int, default=768)
    p.add_argument("--n-layers", type=int, default=12)
    p.add_argument("--n-heads", type=int, default=12)
    p.add_argument("--d-ff", type=int, default=3072)
    p.add_argument("--tp", type=int, default=None)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    penv, mesh, device = launcher_init(
        tp=1 if args.tp is None else args.tp, device=args.device)
    step_fn = make_image_train_step(mesh)
    log_metrics = rank_logger(penv)
    batch = args.per_device_batch * data_parallel_size(mesh)  # global
    config = ViTConfig(
        image_size=args.image_size, patch_size=args.patch_size,
        num_classes=args.num_classes, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff)
    tx = make_optimizer(3e-4, warmup_steps=10, decay_steps=args.steps + 10)
    state = create_vit_train_state(
        config, random_vit_params(config, 0), tx, device=device,
        mesh=mesh if axis_size(mesh, "tp") > 1 else None)

    gen = torch.Generator(device).manual_seed(0)
    images = torch.randn((batch, args.image_size, args.image_size, 3),
                         generator=gen, device=device, dtype=torch.bfloat16)
    labels = torch.zeros((batch,), dtype=torch.int32, device=device)

    state, metrics = step_fn(state, images, labels)
    float(metrics["loss"])  # the first step done before timing

    prof = StepProfiler.from_env()
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        prof.step(step)
        state, metrics = step_fn(state, images, labels)
        if step % args.log_every == 0 or step == args.steps:
            loss = float(metrics["loss"])
            ips = step * batch / (time.perf_counter() - t0)
            log_metrics(step, loss=loss, images_per_sec=ips,
                        images_per_sec_per_chip=ips / penv.num_processes)
    float(metrics["loss"])
    prof.close()
    ips = args.steps * batch / (time.perf_counter() - t0)
    log_metrics(args.steps, final=True, images_per_sec=ips,
                images_per_sec_per_chip=ips / penv.num_processes)
    return ips


if __name__ == "__main__":
    main()
