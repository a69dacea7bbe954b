"""Atomic, resumable checkpoints of arrays and tensors."""
