"""Workload for the multi-process tier: join the process group from the
operator's env contract, run every collective of ``ops/collectives.py``
over the ``dp`` axis of a ``dp = world`` mesh, check each value, print
one JSON line.

PyTorch port of ``kubeflow_tpu/testing/collective_check.py``: success
means the rendezvous and the cross-process collectives both work.
``python -m kubeflow_tpu_torch.testing.collective_check --device cpu``
in each rank (``run_collective_check.py`` starts the gang); the default
device is the card, one rank on each (``cuda:(rank % device count)``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict


def check_collectives(mesh, device) -> Dict[str, bool]:
    """Each collective over ``dp`` on inputs whose every entry names
    the rank and the position it came from, against the values the
    reference's layouts give (``kubeflow_tpu/ops/collectives.py``)."""
    import torch

    from kubeflow_tpu_torch.ops import collectives as col
    from kubeflow_tpu_torch.parallel.mesh import axis_index, axis_size

    n, r = axis_size(mesh, "dp"), axis_index(mesh, "dp")
    rows, cols = 2 * n, 3 * n
    # the full array every rank agrees on; rank r holds row block r
    full = torch.arange(rows * cols, dtype=torch.float32,
                        device=device).reshape(rows, cols)
    mine = full[2 * r:2 * r + 2]
    blocks = full.reshape(n, 2, cols)
    ok = {}
    ok["all_reduce"] = torch.equal(col.all_reduce(mine, mesh, "dp"),
                                   blocks.sum(0))
    ok["all_gather"] = torch.equal(col.all_gather(mine, mesh, "dp"), full)
    # reduce_scatter: rank r holds column block r of the full array
    cblock = full[:, 3 * r:3 * r + 3]
    summed = full.reshape(rows, n, 3).sum(1)
    ok["reduce_scatter"] = torch.equal(
        col.reduce_scatter(cblock, mesh, "dp"), summed[2 * r:2 * r + 2])
    ok["all_to_all"] = torch.equal(col.all_to_all(mine, mesh, "dp"), cblock)
    src = (r - 1) % n
    ok["ppermute"] = torch.equal(col.ppermute_shift(mine, mesh, "dp", 1),
                                 full[2 * src:2 * src + 2])
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as tdist

    from kubeflow_tpu_torch.parallel import distributed as dist
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from kubeflow_tpu_torch.utils.device import resolve_device

    penv = dist.from_env()
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda",
                              penv.process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.initialize(penv, backend="nccl" if device.type == "cuda"
                    else "gloo")
    mesh = create_mesh(MeshConfig(dp=penv.num_processes),
                       device_type=device.type)
    n = tdist.get_world_size()
    checks = check_collectives(mesh, device)
    ok = n == penv.num_processes and all(checks.values())
    print(json.dumps({
        "process_id": penv.process_id,
        "processes": n,
        "backend": tdist.get_backend(),
        "collectives": checks,
        "ok": ok,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    rc = main()
    import torch.distributed as tdist

    tdist.destroy_process_group()
    sys.exit(rc)
