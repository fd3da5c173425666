"""Pipelines of the port: `phase2`, `phase3`, `phase4`, `phase4_enhanced`,
`create_embeddings`, the smoke checks and status of `fast_test`, and their
shared `common` plumbing."""
