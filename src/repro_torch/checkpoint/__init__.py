"""Atomic, checksummed checkpoints of nested state (``checkpointer``)."""
