"""Optimizers over dicts of tensors (``sgd``, ``adam``, ``adamw``,
``adam_rows``, ``apply_updates``), learning-rate schedules and gradient
utilities (global-norm clipping, microbatching, int8 error-feedback
all-reduce)."""
