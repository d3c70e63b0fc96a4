"""K1: the fused gather-GEMM sparse conv, as a hand-written CUDA kernel.

Port of df3d/ops/pallas/sparse_conv_kernel.py (`_kernel_v2`). The kernel is
`df3d_torch/csrc/sparse_conv.cu` (its header note gives the design and what
bounds it: per 64-row tile and tap it compacts the hit rows into chunks of
8 and runs them on the tensor cores as 3xTF32); this module holds its
wrapper, its launch count and its plain PyTorch version:

* `sparse_conv_cuda` launches the kernel on CUDA tensors and raises on
  anything else. It never falls back.
* `sparse_conv_plain` computes the same function with `index_select` +
  `einsum`. `ops.sparse.apply_sparse_conv` uses it for CPU tensors; the
  tests and `chip_smoke.py` hold the kernel against it.
"""

from __future__ import annotations

import ctypes

import torch

from df3d_torch.ops import build

SOURCE = "sparse_conv.cu"
# the kernel pads Cin to a multiple of 8 in shared memory, up to this, and
# keeps a bit per tap
MAX_CIN = 128
MAX_TAPS = 128
# kernel launches made by `sparse_conv_cuda` since the last reset
launches = 0


def sparse_conv_plain(features: torch.Tensor, gather_idx: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """features (B, N_in, Cin); gather_idx (B, K*N_out) tap-major with
    miss == N_in; weights (K, Cin, Cout) -> (B, N_out, Cout)."""
    b, n_in, cin = features.shape
    k = weights.shape[0]
    n_out = gather_idx.shape[1] // k
    padded = torch.cat([features, features.new_zeros(b, 1, cin)], 1)
    base = torch.arange(b, device=features.device)[:, None] * (n_in + 1)
    g = padded.reshape(b * (n_in + 1), cin).index_select(
        0, (gather_idx.long() + base).reshape(-1))
    return torch.einsum("bknc,kcd->bnd", g.view(b, k, n_out, cin), weights)


def _launcher():
    """The C entry point, built and loaded on first use. Pointers and the
    stream go as c_void_p: ctypes would pass a bare int as 32 bits."""
    fn = build.load(SOURCE).df3d_sparse_conv_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    return fn


def sparse_conv_cuda(features: torch.Tensor, gather_idx: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Launch K1 on PyTorch's current stream; same contract as
    `sparse_conv_plain`. Raises unless every input is a contiguous CUDA
    tensor of the expected type and shape."""
    global launches
    for name, t in (("features", features), ("gather_idx", gather_idx),
                    ("weights", weights)):
        if not t.is_cuda:
            raise RuntimeError(f"sparse_conv_cuda: {name} is not a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"sparse_conv_cuda: {name} is not contiguous")
    if features.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("sparse_conv_cuda: features and weights must be f32")
    if gather_idx.dtype != torch.int32:
        raise TypeError("sparse_conv_cuda: gather_idx must be int32")
    if features.dim() != 3 or weights.dim() != 3 or gather_idx.dim() != 2:
        raise ValueError("sparse_conv_cuda: expected (B, N, Cin), "
                         "(B, K*N_out) and (K, Cin, Cout)")
    b, n_in, cin = features.shape
    k, wcin, cout = weights.shape
    if wcin != cin or gather_idx.shape[0] != b or gather_idx.shape[1] % k:
        raise ValueError(
            f"sparse_conv_cuda: shapes {tuple(features.shape)}, "
            f"{tuple(gather_idx.shape)}, {tuple(weights.shape)} disagree")
    if cin > MAX_CIN or k > MAX_TAPS:
        raise ValueError(f"sparse_conv_cuda: Cin {cin} > {MAX_CIN} or "
                         f"{k} taps > {MAX_TAPS}")
    if len({features.device, gather_idx.device, weights.device}) != 1:
        raise ValueError("sparse_conv_cuda: inputs on different devices")
    n_out = gather_idx.shape[1] // k
    out = torch.empty(b, n_out, cout, device=features.device,
                      dtype=torch.float32)
    if b == 0 or n_out == 0 or cout == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            features.data_ptr(), gather_idx.data_ptr(), weights.data_ptr(),
            out.data_ptr(), b, n_in, n_out, k, cin, cout, stream)
    if err != 0:
        raise RuntimeError(f"sparse_conv_cuda: launch failed, cudaError {err}")
    launches += 1
    return out
