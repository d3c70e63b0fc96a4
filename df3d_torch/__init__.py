"""df3d_torch: the PyTorch/CUDA port of df3d for NVIDIA Hopper.

Mirrors the module layout and names of the JAX package `df3d/` so each
counterpart is easy to find. It imports torch and numpy only (and PyYAML
where `config.load_config` or an override parses YAML); the sparse
conv body (`csrc/sparse_conv.cu`) and the multi-scale deformable-attention
sampling (`csrc/msda.cu`) run as hand-written CUDA kernels on CUDA tensors
and as their plain PyTorch versions on CPU tensors.
"""
