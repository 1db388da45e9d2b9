"""Model serving: the per-request `/generate` path."""
