"""The Kubernetes pieces the port's jobs need (trimmed copies): object
builders, and an HTTP client for the ConfigMaps trial metrics live in."""
