"""Experiments run through the port (twins of the reference's
`experiments/` scripts)."""
