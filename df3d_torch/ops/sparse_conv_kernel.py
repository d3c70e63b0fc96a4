"""K1: the fused gather-GEMM sparse conv, as a hand-written CUDA kernel.

Port of df3d/ops/pallas/sparse_conv_kernel.py (`_kernel_v2`). The kernel is
`df3d_torch/csrc/sparse_conv.cu` (its header note gives the design and what
bounds it: per 64-row tile and tap it compacts the hit rows into chunks of
8 and runs them on the tensor cores, as 3xTF32 for an f32 table and as one
bf16 product for a bf16 one); this module holds its wrappers, their launch
counts and their plain PyTorch versions:

* `sparse_conv_cuda` launches the kernel on CUDA tensors and raises on
  anything else. It never falls back. `sparse_conv_cuda_dx` is the same
  launch made for an input gradient (the backward of
  `ops.sparse.apply_sparse_conv`: the same plan with flipped, transposed
  taps, or a transposed plan), counted apart in `bwd_launches`.
* `sparse_conv_plain` computes the same function with `index_select` +
  `einsum`. `ops.sparse.apply_sparse_conv` and its backward use it for CPU
  tensors; the tests and `chip_smoke.py` hold the kernel against it.
* `sparse_conv_bf16_cuda` launches K1's bf16 form, a kernel of its own on
  warpgroup `wgmma` (a bf16 table and bf16 weights, f32 accumulation in
  registers, bf16 output rounded once), counted in `bf16_launches`; it
  first lays W out as the kernel's shared-memory images
  (`bf16_image_elems` sizes them). `sparse_conv_bf16_plain` is its plain
  version. The bf16 serving profile runs it (`serving.py`).
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
# kernel launches made by `sparse_conv_cuda` (forward),
# `sparse_conv_cuda_dx` (input gradients) and `sparse_conv_bf16_cuda` (the
# bf16 table) since the last reset
launches = 0
bwd_launches = 0
bf16_launches = 0


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


def sparse_conv_bf16_plain(features: torch.Tensor, gather_idx: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's function: the table and the weights rounded to
    bf16, the products (exact) summed, the sum rounded to bf16. The sum is
    taken in f64, exact to ~2^-53 of its terms, so the reference does not
    carry an f32 summation order's error: where the terms cancel (a sum
    ~1e-4 of terms summing to ~50 in magnitude), two f32 orders land
    several bf16 ulps apart. Same shapes as `sparse_conv_plain`; -> bf16
    (rounded through f32)."""
    return sparse_conv_plain(features.bfloat16().double(), gather_idx,
                             weights.bfloat16().double()).float().bfloat16()


# sparse_conv.cu's C entry points and their arguments. Pointers and the
# stream go as c_void_p: ctypes would pass a bare int as 32 bits.
ENTRY_POINTS = {
    "df3d_sparse_conv_f32": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                             + [ctypes.c_void_p]),
    "df3d_sparse_conv_bf16": ([ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                                       ctypes.c_void_p]
                              + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
    "df3d_sparse_conv_bf16_image_elems": [ctypes.c_int] * 3,
}
RESTYPES = {"df3d_sparse_conv_bf16_image_elems": ctypes.c_longlong}
# the bf16 kernel's widths: Cin padded to one (KP), Cout's column block
BF16_WIDTHS = (16, 32, 64, 128)


def bind(lib: ctypes.CDLL, names=tuple(ENTRY_POINTS)) -> ctypes.CDLL:
    """Set the signatures of the entry points `names` of a library built
    from sparse_conv.cu and return it."""
    for name in names:
        fn = getattr(lib, name)
        fn.restype = RESTYPES.get(name, ctypes.c_int)
        fn.argtypes = ENTRY_POINTS[name]
    return lib


_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built, loaded and bound on first use."""
    global _lib
    if _lib is None:
        _lib = bind(build.load(SOURCE))
    return _lib


def bf16_widths(cin: int, cout: int) -> tuple[int, int, int]:
    """(KP, N, column blocks) of the bf16 kernel: Cin padded to the first
    of BF16_WIDTHS that holds it, Cout's column block likewise (128 and
    more blocks beyond). Raises ValueError for a Cin or Cout it does not
    take."""
    if not 0 < cin <= MAX_CIN or cout <= 0:
        raise ValueError(f"sparse_conv_bf16_cuda: Cin {cin} not in "
                         f"[1, {MAX_CIN}] or Cout {cout} < 1")
    kp = next(v for v in BF16_WIDTHS if v >= cin)
    n = next((v for v in BF16_WIDTHS if v >= cout), BF16_WIDTHS[-1])
    return kp, n, -(-cout // n)


def bf16_image_elems(k: int, cin: int, cout: int) -> int:
    """bf16 elements of W's images for the bf16 kernel
    (`df3d_sparse_conv_bf16_image_elems`): one KP x N block a tap and
    column block."""
    kp, n, blocks = bf16_widths(cin, cout)
    return k * blocks * kp * n


def sparse_conv_cuda(features: torch.Tensor, gather_idx: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Launch K1 on PyTorch's current stream; same contract as
    `sparse_conv_plain`. Raises unless every input is a contiguous CUDA
    tensor of the expected type and shape."""
    global launches
    out, launched = _launch(features, gather_idx, weights)
    launches += launched
    return out


def sparse_conv_cuda_dx(features: torch.Tensor, gather_idx: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """`sparse_conv_cuda` for an input gradient: the same launch, counted
    in `bwd_launches`."""
    global bwd_launches
    out, launched = _launch(features, gather_idx, weights)
    bwd_launches += launched
    return out


def sparse_conv_bf16_cuda(features: torch.Tensor, gather_idx: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Launch K1's bf16 form on PyTorch's current stream; the contract of
    `sparse_conv_bf16_plain`, but features and weights must be bf16 CUDA
    tensors already. Raises otherwise; never falls back."""
    global bf16_launches
    out, launched = _launch(features, gather_idx, weights, torch.bfloat16)
    bf16_launches += launched
    return out


def _launch(features, gather_idx, weights, dtype=torch.float32
            ) -> tuple[torch.Tensor, int]:
    """Check the inputs and launch K1 on a `dtype` table; -> (output of
    that dtype, 1 if it launched, else 0 for an empty output)."""
    b, n_in, n_out, k, cin, cout = _checked(features, gather_idx, weights,
                                            dtype)
    out = torch.empty(b, n_out, cout, device=features.device, dtype=dtype)
    if b == 0 or n_out == 0 or cout == 0:
        return out, 0
    lib = _library()
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        if dtype == torch.float32:
            err = lib.df3d_sparse_conv_f32(
                features.data_ptr(), gather_idx.data_ptr(),
                weights.data_ptr(), out.data_ptr(), b, n_in, n_out, k, cin,
                cout, stream)
        else:
            n_img = bf16_image_elems(k, cin, cout)
            images = torch.empty(n_img, device=features.device,
                                 dtype=torch.bfloat16)
            err = lib.df3d_sparse_conv_bf16(
                features.data_ptr(), gather_idx.data_ptr(),
                weights.data_ptr(), images.data_ptr(), n_img, out.data_ptr(),
                b, n_in, n_out, k, cin, cout, stream)
    if err != 0:
        raise RuntimeError(f"sparse_conv_cuda: launch failed, cudaError {err}")
    return out, 1


def _checked(features, gather_idx, weights, dtype) -> tuple:
    """Raise unless the inputs are contiguous CUDA tensors of one device,
    the table and weights of `dtype`, the indices int32, of agreeing shapes
    within the kernel's limits; -> (B, N_in, N_out, K, Cin, Cout)."""
    for name, t in (("features", features), ("gather_idx", gather_idx),
                    ("weights", weights)):
        if not t.is_cuda:
            raise RuntimeError(f"sparse_conv_cuda: {name} is not a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"sparse_conv_cuda: {name} is not contiguous")
    if features.dtype != dtype or weights.dtype != dtype:
        raise TypeError(f"sparse_conv_cuda: features and weights must be "
                        f"{dtype}")
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
    return b, n_in, gather_idx.shape[1] // k, k, cin, cout
