"""Training entry points of the port (``python -m
kubeflow_tpu_torch.examples.<name>``) and their launcher scaffolding."""
