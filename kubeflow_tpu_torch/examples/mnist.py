"""MNIST training job: the one-worker correctness smoke.

PyTorch port of ``kubeflow_tpu/examples/mnist.py``:
``python -m kubeflow_tpu_torch.examples.mnist`` trains the MNIST CNN with
the image train step and ``make_optimizer(1e-3)`` for 100 steps of
batch 128 on synthetic class-conditional blobs (the reference's
``synthetic_mnist``, the same arrays), or on pre-staged idx files with
``--data-dir``. Step batches are drawn as the reference's process 0
draws them (``RandomState(0)``), so both packages train on the same
batches. One JSON metrics line every ``--log-every`` steps (rank 0
alone); ``main`` returns the last logged accuracy. Same flags and
defaults as the reference, plus ``--device`` (CUDA by default). Across
processes the mesh is ``dp``: ``--batch-size`` is the global batch,
every rank draws the same one (the reference's ``RandomState(
process_id)`` would hand each process a different "global" batch) and
trains on its rows. The weights start from ``random_mnist_params(0)``.
"""

from __future__ import annotations

import argparse
import gzip
import os
import struct

import numpy as np
import torch

from kubeflow_tpu_torch.examples.common import launcher_init, rank_logger
from kubeflow_tpu_torch.models.convert import load_params, random_mnist_params
from kubeflow_tpu_torch.models.mnist import MnistCnn
from kubeflow_tpu_torch.train import (
    TrainState,
    make_image_train_step,
    make_optimizer,
)


def load_mnist(data_dir: str) -> tuple:
    """Read pre-staged idx files (``train-images-idx3-ubyte.gz`` and the
    labels'): images ``(N, 28, 28, 1)`` f32 in [0, 1], labels int32."""
    def read_idx(path):
        with gzip.open(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
            ndim = magic & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return np.frombuffer(f.read(), np.uint8).reshape(dims)

    images = read_idx(os.path.join(data_dir, "train-images-idx3-ubyte.gz"))
    labels = read_idx(os.path.join(data_dir, "train-labels-idx1-ubyte.gz"))
    return (images.astype(np.float32)[..., None] / 255.0,
            labels.astype(np.int32))


def synthetic_mnist(n: int = 4096, seed: int = 0) -> tuple:
    """Class-conditional gaussian blobs: learnable, so loss and accuracy
    move."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int32)
    protos = rng.randn(10, 28, 28, 1).astype(np.float32)
    images = protos[labels] + 0.3 * rng.randn(n, 28, 28, 1).astype(
        np.float32)
    return images, labels


def main(argv=None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--data-dir", default="")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    penv, mesh, device = launcher_init(tp=1, device=args.device)
    step_fn = make_image_train_step(mesh)
    log_metrics = rank_logger(penv)
    images, labels = (load_mnist(args.data_dir) if args.data_dir
                      else synthetic_mnist())
    tx = make_optimizer(args.learning_rate, warmup_steps=10,
                        decay_steps=args.steps)
    model = load_params(MnistCnn(), random_mnist_params(0))
    state = TrainState.create(model.to(device).train(), tx)

    rng = np.random.RandomState(0)       # the global batch, on every rank
    final_acc = 0.0
    for step in range(1, args.steps + 1):
        idx = rng.randint(0, len(images), size=args.batch_size)
        state, metrics = step_fn(state, torch.from_numpy(images[idx]),
                                 torch.from_numpy(labels[idx]))
        if step % args.log_every == 0 or step == args.steps:
            final_acc = float(metrics["accuracy"])
            log_metrics(step, loss=metrics["loss"], accuracy=final_acc)
    return final_acc


if __name__ == "__main__":
    main()
