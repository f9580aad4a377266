"""Measurement pipelines."""
