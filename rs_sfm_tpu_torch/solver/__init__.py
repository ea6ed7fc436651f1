"""Minimal solver, RANSAC, fused LM refinement and the estimation pipeline."""
