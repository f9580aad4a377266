"""Transforms, the fused setup and the phase-moments reduction."""
