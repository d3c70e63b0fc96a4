"""df3d_torch: the PyTorch/CUDA port of df3d for NVIDIA Hopper.

Mirrors the module layout and names of the JAX package `df3d/` so each
counterpart is easy to find. It imports torch and numpy only; the sparse
conv body runs as a hand-written CUDA kernel (`csrc/sparse_conv.cu`) on
CUDA tensors and as its plain PyTorch version on CPU tensors.
"""
