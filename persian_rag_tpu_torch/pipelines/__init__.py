"""Pipelines of the port: `phase3`, `create_embeddings`, their shared
`common` plumbing and `fast_test.show_system_status`."""
