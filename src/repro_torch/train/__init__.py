"""Serving steps (training is not yet ported)."""
