"""Synthetic archives (sim/fake)."""
