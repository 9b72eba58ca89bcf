"""ResNet-50 training benchmark: the tf_cnn_benchmarks equivalent.

PyTorch port of ``kubeflow_tpu/examples/resnet.py``:
``python -m kubeflow_tpu_torch.examples.resnet --steps 50`` trains
ResNet-50 (bf16 compute over f32 parameters, the image train step with
``make_optimizer(0.1)``) on one synthetic batch, or with ``--data-dir``
on ``.f32`` shards (record = ``[label, pixels...]``) read by the native
loader (``data/loader.py``) and fed to the card by ``device_feed``,
the pixels cast to bf16 on the host so half the bytes cross. After
``--warmup-steps`` untimed steps it reports images/s in one JSON
metrics line every ``--log-every`` steps and a final line, and returns
images/s. Same flags and defaults as the reference, plus ``--device``
(CUDA by default); the step profiler reads ``KFTPU_PROFILE_DIR``/
``_START``/``_STEPS``. Across processes the mesh is ``dp`` (the image
step splits the batch only): the batch is ``per_device_batch × dp``
rows, every rank makes the same global batch (the same seed, or the
same loader order) and trains on its rows, with BatchNorm statistics
over the global batch; rank 0 alone logs. The weights start from
``random_resnet_params(config, 0)``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from kubeflow_tpu_torch.data import DataLoader, device_feed, read_shards
from kubeflow_tpu_torch.examples.common import launcher_init, rank_logger
from kubeflow_tpu_torch.models.convert import random_resnet_params
from kubeflow_tpu_torch.models.resnet import resnet50
from kubeflow_tpu_torch.parallel.mesh import data_parallel_size
from kubeflow_tpu_torch.train import (
    create_image_train_state,
    make_image_train_step,
    make_optimizer,
)
from kubeflow_tpu_torch.utils.profiler import StepProfiler


def main(argv=None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--warmup-steps", type=int, default=3)
    p.add_argument("--per-device-batch", type=int, default=128)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--data-dir", default=None,
                   help="directory of .f32 shards (record = [label, "
                        "pixels...]); default: synthetic tensors")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    penv, mesh, device = launcher_init(tp=1, device=args.device)
    step_fn = make_image_train_step(mesh)
    log_metrics = rank_logger(penv)
    batch = args.per_device_batch * data_parallel_size(mesh)  # global
    with torch.device("meta"):
        config = resnet50(num_classes=args.num_classes).config
    tx = make_optimizer(0.1, warmup_steps=10, decay_steps=args.steps + 10)
    state = create_image_train_state(config, random_resnet_params(config, 0),
                                     tx, device=device)
    size = args.image_size

    # the native loader and the device feed on the --data-dir path
    # (records = [label, pixels...]); labels split out and pixels cast to
    # bf16 on the HOST so half the bytes cross to the card
    loader = None
    feed = None
    if args.data_dir:
        loader = DataLoader(read_shards(args.data_dir, size * size * 3 + 1),
                            batch)

        def split(rec):
            # one pass over the pixels: the strided slice cast to bf16
            pixels = torch.from_numpy(rec)[:, 1:].to(torch.bfloat16)
            return (pixels.reshape(batch, size, size, 3),
                    torch.from_numpy(rec[:, 0].astype(np.int32)))

        feed = device_feed(loader, mesh, transform=split)
    else:
        gen = torch.Generator(device).manual_seed(0)
        images = torch.randn((batch, size, size, 3), generator=gen,
                             device=device, dtype=torch.bfloat16)
        labels = torch.zeros((batch,), dtype=torch.int32, device=device)

    def next_batch():
        if feed is not None:
            return next(feed)
        return images, labels

    try:
        metrics = None
        for _ in range(args.warmup_steps):
            state, metrics = step_fn(state, *next_batch())
        if metrics is not None:
            float(metrics["loss"])  # the warm-up done before timing

        prof = StepProfiler.from_env()
        t0 = time.perf_counter()
        for step in range(1, args.steps + 1):
            prof.step(step)
            state, metrics = step_fn(state, *next_batch())
            if step % args.log_every == 0 or step == args.steps:
                loss = float(metrics["loss"])
                ips = step * batch / (time.perf_counter() - t0)
                log_metrics(step, loss=loss, images_per_sec=ips,
                            images_per_sec_per_chip=ips / penv.num_processes)
        float(metrics["loss"])
        prof.close()
    finally:
        if loader is not None:
            loader.close()
    ips = args.steps * batch / (time.perf_counter() - t0)
    log_metrics(args.steps, final=True, images_per_sec=ips,
                images_per_sec_per_chip=ips / penv.num_processes)
    return ips


if __name__ == "__main__":
    main()
