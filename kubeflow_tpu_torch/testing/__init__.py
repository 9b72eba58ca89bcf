"""Multi-process test harness of the port: ``run_multiprocess`` starts a
gang of ranks wired with the operator's env contract; the collective
check is the smoke workload it runs."""

from kubeflow_tpu_torch.testing.multiprocess import (  # noqa: F401
    ProcResult,
    run_multiprocess,
)
