"""Small-matrix linear algebra and the hand-written kernels."""
