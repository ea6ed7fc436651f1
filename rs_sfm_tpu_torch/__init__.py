"""rs_sfm_tpu_torch — the PyTorch + CUDA port of rs_sfm_tpu for one NVIDIA H100.

Rolling-shutter-aware differential SfM (Zhuang et al., ICCV 2017): the
dense flow between two rolling-shutter frames (pyramidal variational, with
a forward-backward occlusion test) goes through a 9-point minimal solver
inside RANSAC, a Schur-complement Levenberg–Marquardt joint refinement,
model-feedback passes, and a z-buffered back-projection to a global-shutter
image.

The JAX package `rs_sfm_tpu` stays the reference; this package mirrors its
layout and module names so each counterpart is easy to find.  Plain tensor
code is PyTorch; the hot kernels (RANSAC scoring, the fused Schur-LM
iteration, the flow's warp, SOR sweeps and median) are hand-written CUDA
C++ for sm_90a under `csrc/`, built at
first use by `ops.kernels._build`.  On CPU tensors every kernel wrapper runs
its plain PyTorch twin, which is what the CPU tests exercise.

Dtype policy (the JAX package's rule, rs_sfm_tpu/config.py):
  * dense per-pixel tensors are float32;
  * the minimal solver's tiny matrices use `config.CORE_DTYPE`, float64 by
    default (the card has real f64).

TF32 is disabled for matmuls and cuDNN on import
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`): the LM Gram sums and the
minimal solver need full float32/float64 products.

This package never imports JAX.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["config", "geom", "solver", "ops", "rectify", "data", "flow",
           "models", "eval", "parallel", "cli"]
