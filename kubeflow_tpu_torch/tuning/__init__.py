"""The workload side of hyperparameter tuning (a trimmed copy)."""
