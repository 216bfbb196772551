"""Inference callables (training is not ported yet)."""
