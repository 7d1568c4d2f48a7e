"""Hand-written Hopper kernels, one subpackage per TPU kernel of the
reference: ``csrc/`` (CUDA C++), ``kernel.py`` (wrapper with a launch
count), ``ref.py`` (the plain PyTorch version CPU tensors take)."""
