"""Optimizers over dicts of tensors: ``sgd``, ``adam``, ``apply_updates``."""
