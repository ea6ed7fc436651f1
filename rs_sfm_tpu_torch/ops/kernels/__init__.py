"""Hand-written Hopper kernels (csrc/*.cu), their ctypes wrappers and their
plain PyTorch twins.  Wrappers launch the kernel for CUDA tensors and run
the twin for CPU tensors; each counts its launches in `<wrapper>.launches`."""
