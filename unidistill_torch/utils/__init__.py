"""Utilities: the name registry and the FLOP counter."""
