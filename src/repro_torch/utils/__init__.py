"""Tooling: checkpoints."""
