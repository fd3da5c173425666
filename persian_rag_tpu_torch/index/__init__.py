"""Device-resident search indexes."""
