"""Layers of the port's language models: plain functions on tensors and
parameter groups, as in the JAX package's ``models/layers``."""
