"""Pipelines of the port (`fast_test.show_system_status` so far)."""
