"""The Kubernetes object builders the port's jobs need (a trimmed copy)."""
