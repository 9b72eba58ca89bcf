"""Command-line entry point for the multi-process collective check.

``python -m kubeflow_tpu_torch.testing.run_collective_check --processes
4 --device cpu`` starts the gang (``run_multiprocess``) and exits
non-zero if any rank fails: the command an end-to-end check runs.
"""

from __future__ import annotations

import argparse
import json
import sys

from kubeflow_tpu_torch.testing.multiprocess import run_multiprocess


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--processes", type=int, default=4)
    p.add_argument("--timeout", type=float, default=180.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    results = run_multiprocess(
        ["-m", "kubeflow_tpu_torch.testing.collective_check",
         "--device", args.device],
        args.processes, timeout_s=args.timeout)
    ok = all(r.returncode == 0 for r in results)
    for r in results:
        line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
        print(f"rank {r.process_id}: rc={r.returncode} {line}")
        if r.returncode != 0 and r.stderr:
            print(r.stderr[-500:], file=sys.stderr)
    print(json.dumps({"processes": args.processes, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
