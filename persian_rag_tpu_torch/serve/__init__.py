"""HTTP serving with request micro-batching."""
