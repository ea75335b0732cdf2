"""Segment reductions, activations, and the φ chain with its CUDA kernel."""
