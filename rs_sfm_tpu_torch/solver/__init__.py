"""Minimal solver, RANSAC, the two LM refinement engines (fused kernels,
plain tensors) and the estimation pipeline."""
