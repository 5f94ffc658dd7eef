"""Operational tools: checkpoint conversion and audit, activation dumps,
timing and drift probes (the reference's tools/ dir)."""
