"""Batch prediction job: offline inference over a JSONL dataset.

PyTorch port of ``kubeflow_tpu/serving/batch_predict.py`` (the
tf-batch-predict package's k8s Job running inference from a model path
over input files). The runner loads a versioned model from the store,
streams instances from input JSONL, predicts in size-``batch`` chunks
cast to f32 and padded to the batch size (one shape, as the reference
compiles one), and writes predictions JSONL. A chunk the model cannot
take is refused before the launch by the check ``:predict`` runs
(``LoadedModel.input_error``): a token model's f32 chunk refuses, as
the reference's cast leaves it. The model loads onto the card unless
``device="cpu"`` is asked for.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from kubeflow_tpu_torch.k8s import objects as o
from kubeflow_tpu_torch.serving.model_store import load_latest, load_version


def _read_instances(path: str) -> Iterator[Any]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def run_batch_predict(
    model_base_path: str,
    input_path: str,
    output_path: str,
    *,
    version: Optional[int] = None,
    batch_size: int = 32,
    device=None,
) -> Dict[str, Any]:
    """Returns a summary dict; predictions land in ``output_path``."""
    model = (load_version(model_base_path, version, device=device)
             if version is not None
             else load_latest(model_base_path, device=device))
    if model is None:
        raise FileNotFoundError(f"no model versions under {model_base_path}")

    t0 = time.perf_counter()
    n_total = 0
    with open(output_path, "w") as out:
        batch: List[Any] = []

        def flush() -> None:
            nonlocal n_total
            if not batch:
                return
            arr = np.asarray(batch, dtype=np.float32)
            n = arr.shape[0]
            if n < batch_size:  # pad to the compiled batch shape
                pad = np.zeros((batch_size - n,) + arr.shape[1:],
                               dtype=arr.dtype)
                arr = np.concatenate([arr, pad])
            bad = model.input_error(arr.shape, arr.dtype)
            if bad:
                raise ValueError(bad)
            preds = model.predict(arr)[:n]
            for p in preds:
                out.write(json.dumps({"prediction": p.tolist()}) + "\n")
            n_total += n
            batch.clear()

        for inst in _read_instances(input_path):
            batch.append(inst)
            if len(batch) >= batch_size:
                flush()
        flush()
    wall = time.perf_counter() - t0
    return {
        "model_version": model.version,
        "instances": n_total,
        "wall_time_s": round(wall, 3),
        "instances_per_sec": round(n_total / wall, 2) if wall else 0.0,
        "output": output_path,
    }


def batch_predict_job(
    name: str,
    ns: str,
    *,
    image: str = "kubeflow-tpu/serving:v1alpha1",
    model_base_path: str,
    input_path: str,
    output_path: str,
    version: Optional[int] = None,
    batch_size: int = 32,
    gpus: int = 0,
) -> o.Obj:
    """The k8s Job manifest (tf-batch-predict.libsonnet parity): the
    reference's, running this module and asking for ``gpus`` cards as
    ``nvidia.com/gpu`` where it asks for TPU chips."""
    args = ["--model-base-path", model_base_path,
            "--input", input_path, "--output", output_path,
            "--batch-size", str(batch_size)]
    if version is not None:
        args += ["--version", str(version)]
    resources = {"limits": {"nvidia.com/gpu": gpus}} if gpus else None
    pod = o.pod_spec(
        [o.container(
            "batch-predict", image,
            command=["python", "-m",
                     "kubeflow_tpu_torch.serving.batch_predict"],
            args=args,
            resources=resources,
        )],
        restart_policy="OnFailure",
    )
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": o.metadata(name, ns),
        "spec": {"template": {"metadata": {"labels": {"app": name}},
                              "spec": pod},
                 "backoffLimit": 2},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="kubeflow_tpu_torch.serving.batch_predict")
    p.add_argument("--model-base-path", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--version", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    summary = run_batch_predict(
        args.model_base_path, args.input, args.output,
        version=args.version, batch_size=args.batch_size,
        device=args.device)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
