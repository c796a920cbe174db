"""serve (port of repro.serve)."""
