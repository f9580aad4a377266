"""Sufficient statistics, the batched Newton loop and the batched fit."""
