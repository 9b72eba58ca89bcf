"""Elastic training: checkpoint-reshard-resume on a gang resize.

PyTorch port of ``kubeflow_tpu/elastic``: the resize engine that takes
a live run from topology A to topology B with the step clock intact.

- :mod:`kubeflow_tpu_torch.elastic.snapshot`: the exactly-once resize
  snapshot of the train state, and the production
  :class:`~kubeflow_tpu_torch.operators.tpujob.PreemptionCheckpointer`
  binding over ``spec.checkpointDir``.
- :mod:`kubeflow_tpu_torch.elastic.reshard`: the mesh for the new slice
  count, the specs re-derived from the topology-independent logical-axis
  rules, and the checkpoint restored into a state built over the new
  mesh.
- :mod:`kubeflow_tpu_torch.elastic.coordinator`: the worker-side
  protocol: catch the resize signal, barrier, save, re-enter a process
  group at the new world size, reshard, resume at ``step+1``.
"""

from kubeflow_tpu_torch.elastic.coordinator import (  # noqa: F401
    ElasticCoordinator,
    ResizeSignal,
    cr_resize_target,
    install_sigterm,
)
from kubeflow_tpu_torch.elastic.reshard import (  # noqa: F401
    ReshardMismatchError,
    abstract_target,
    lm_init_fn,
    mesh_for_slices,
    restore_resharded,
    shard_put,
    shardings_for,
    validate_global_shapes,
)
from kubeflow_tpu_torch.elastic.snapshot import (  # noqa: F401
    DirCheckpointer,
    ElasticSnapshotter,
)
