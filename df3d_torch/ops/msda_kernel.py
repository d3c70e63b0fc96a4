"""K2: multi-scale deformable-attention sampling, as a hand-written CUDA kernel.

Port of df3d/ops/pallas/msda_kernel.py (`_kernel`). The kernel is
`df3d_torch/csrc/msda.cu` (its header note gives the design and what bounds
it); this module holds its wrapper, its launch count and its plain PyTorch
version. Both take the reference layout:

    value (B, LenV, nH, D), sampling_locations (B, Q, nH, L, P, 2) in [0, 1],
    attention_weights (B, Q, nH, L, P)  ->  (B, Q, nH * D)

* `msda_cuda` launches the kernel on CUDA tensors and raises on anything
  else. It never falls back. The kernel has a warp path for the presets'
  shapes (nH 8, D 16, P 4, and L 3 for CenterPoint + 3D-DF or L 1 for
  TransFusion + 3D-DF) and a general path for the rest (`warp_path` says
  which).
* `msda_plain` computes the same function with an explicit four-corner
  gather. `ops.msda.ms_deform_attn` uses it for CPU tensors; the tests and
  `chip_smoke.py` hold the kernel against it.
* `msda_bwd_cuda` launches the kernel's backward (dvalue, dloc, dattn from
  dL/dout; no float atomics, so a repeat launch gives the same bits),
  counted apart in `bwd_launches`, with the scratch `bwd_scratch` sizes
  from the shapes; `msda_bwd_plain` is autograd of `msda_plain`, used
  only by the tests and `chip_smoke.py` (on CPU tensors autograd runs
  through `msda_plain` itself).
"""

from __future__ import annotations

import ctypes

import torch

from df3d_torch.ops import build

SOURCE = "msda.cu"
MAX_LEVELS = 8  # kMaxLevels in csrc/msda.cu
# the backward's scratch layout (kHeader, kScanTile in csrc/msda.cu);
# rows, samples and record positions are ints there
BWD_HEADER = 4
BWD_SCAN_TILE = 4096
INT_MAX = 2**31 - 1
# kernel launches made by `msda_cuda` (forward) and `msda_bwd_cuda`
# (backward) since the last reset
launches = 0
bwd_launches = 0


def msda_plain(value: torch.Tensor, spatial_shapes, sampling_locations:
               torch.Tensor, attention_weights: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling at loc * (W, H) - 0.5, zero padding outside the
    map, times the attention weight, summed over levels x points."""
    b, len_v, nh, d = value.shape
    q, nl, npnt = sampling_locations.shape[1], *sampling_locations.shape[3:5]
    heads = torch.arange(nh, device=value.device).view(1, 1, nh, 1)
    batch = torch.arange(b, device=value.device).view(b, 1, 1, 1)
    rows = value.reshape(b * len_v * nh, d)
    out = value.new_zeros(b, q, nh, d)
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lid]          # (B, Q, nH, P, 2)
        wgt = attention_weights[:, :, :, lid]           # (B, Q, nH, P)
        px = loc[..., 0] * w - 0.5
        py = loc[..., 1] * h - 0.5
        x0, y0 = torch.floor(px), torch.floor(py)
        dx, dy = px - x0, py - y0
        for cx, cy, cw in ((x0, y0, (1 - dx) * (1 - dy)),
                           (x0 + 1, y0, dx * (1 - dy)),
                           (x0, y0 + 1, (1 - dx) * dy),
                           (x0 + 1, y0 + 1, dx * dy)):
            inb = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
            xi = cx.clamp(0, w - 1).long()
            yi = cy.clamp(0, h - 1).long()
            pix = start + yi * w + xi                   # (B, Q, nH, P)
            g = rows.index_select(0, ((batch * len_v + pix) * nh
                                      + heads).reshape(-1))
            cwt = (wgt * cw * inb)[..., None]
            out += (g.view(b, q, nh, npnt, d) * cwt).sum(3)
        start += h * w
    return out.reshape(b, q, nh * d)


# msda.cu's C entry points, each returning an int, and their arguments.
# Pointers and the stream go as c_void_p: ctypes would pass a bare int as
# 32 bits.
ENTRY_POINTS = {
    "df3d_msda_f32": ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)]
                      + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
    "df3d_msda_warp_path": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7,
    "df3d_msda_bwd_f32": ([ctypes.c_void_p] * 7
                          + [ctypes.c_void_p, ctypes.c_longlong] * 2
                          + [ctypes.POINTER(ctypes.c_int)]
                          + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
}


def bind(lib: ctypes.CDLL, names=tuple(ENTRY_POINTS)) -> ctypes.CDLL:
    """Set the signatures of the entry points `names` of a library built
    from msda.cu and return it."""
    for name in names:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = ENTRY_POINTS[name]
    return lib


_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built, loaded and bound on first use."""
    global _lib
    if _lib is None:
        _lib = bind(build.load(SOURCE))
    return _lib


def warp_path(value: torch.Tensor, spatial_shapes,
              sampling_locations: torch.Tensor) -> bool:
    """Whether `msda_cuda` runs these CUDA inputs on the kernel's warp path
    (the presets' shapes) rather than its general path; the kernel decides
    (`df3d_msda_warp_path`). The output `msda_cuda` allocates is always
    aligned, so it is not asked about."""
    b, len_v, nh, d = value.shape
    q, nl, npnt = (sampling_locations.shape[1],
                   *sampling_locations.shape[3:5])
    return bool(_library().df3d_msda_warp_path(
        value.data_ptr(), sampling_locations.data_ptr(), None,
        len(spatial_shapes), b, len_v, q, nh, d, npnt))


def _checked(fn: str, value: torch.Tensor, spatial_shapes,
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor, *extra) -> tuple:
    """Raise unless the inputs (and `extra` (name, tensor) pairs) are
    contiguous f32 tensors on one CUDA device with the reference layout's
    shapes; returns (levels as (H, W) ints, B, LenV, nH, D, Q, L, P)."""
    tensors = (("value", value), ("sampling_locations", sampling_locations),
               ("attention_weights", attention_weights), *extra)
    for name, t in tensors:
        if not t.is_cuda:
            raise RuntimeError(f"{fn}: {name} is not a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be f32, got {t.dtype}")
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError(f"{fn}: inputs on different devices")
    shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    if value.dim() != 4 or sampling_locations.dim() != 6:
        raise ValueError(f"{fn}: expected value (B, LenV, nH, D) and "
                         "locations (B, Q, nH, L, P, 2)")
    b, len_v, nh, d = value.shape
    q, nl, npnt = (sampling_locations.shape[1],
                   *sampling_locations.shape[3:5])
    if (tuple(sampling_locations.shape) != (b, q, nh, nl, npnt, 2)
            or tuple(attention_weights.shape) != (b, q, nh, nl, npnt)
            or nl != len(shapes) or not 0 < nl <= MAX_LEVELS
            or sum(h * w for h, w in shapes) != len_v):
        raise ValueError(
            f"{fn}: shapes {tuple(value.shape)}, "
            f"{tuple(sampling_locations.shape)}, "
            f"{tuple(attention_weights.shape)} and levels {shapes} disagree")
    return shapes, b, len_v, nh, d, q, nl, npnt


def _flat(shapes) -> ctypes.Array:
    return (ctypes.c_int * (2 * len(shapes)))(*[v for hw in shapes
                                                 for v in hw])


def msda_cuda(value: torch.Tensor, spatial_shapes, sampling_locations:
              torch.Tensor, attention_weights: torch.Tensor) -> torch.Tensor:
    """Launch K2 on PyTorch's current stream; same contract as
    `msda_plain`. Raises unless every input is a contiguous f32 CUDA tensor
    of the expected shape."""
    global launches
    shapes, b, len_v, nh, d, q, nl, npnt = _checked(
        "msda_cuda", value, spatial_shapes, sampling_locations,
        attention_weights)
    out = torch.empty(b, q, nh * d, device=value.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    launch = _library().df3d_msda_f32
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(value.data_ptr(), sampling_locations.data_ptr(),
                     attention_weights.data_ptr(), out.data_ptr(),
                     _flat(shapes), nl, b, len_v, q, nh, d, npnt, stream)
    if err != 0:
        raise RuntimeError(f"msda_cuda: launch failed, cudaError {err}")
    launches += 1
    return out


def msda_bwd_plain(value: torch.Tensor, spatial_shapes,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   grad_output: torch.Tensor) -> tuple:
    """(dvalue, dlocations, dweights): torch autograd of `msda_plain` at
    these inputs for dL/dout = grad_output (B, Q, nH * D)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True)
                  for t in (value, sampling_locations, attention_weights)]
        out = msda_plain(inputs[0], spatial_shapes, *inputs[1:])
        return torch.autograd.grad(out, inputs, grad_output)


def bwd_scratch(b: int, len_v: int, q: int, nh: int, nl: int,
                npnt: int) -> tuple[int, int]:
    """(ints, records) of scratch K2's backward needs at these shapes, as
    `df3d_msda_bwd_f32` checks them (`scratch_ints_for` in csrc/msda.cu):
    a header, a counter per dvalue row (B x LenV x nH), a live bit per
    (query, head) unit, the scan tiles' sums, the live units' list and a
    largest |g| per live unit; and the records of two ints, one per
    possible in-bounds corner (4 per sample, every query live at worst).
    Raises ValueError where the rows or records would not fit an int."""
    n_rows, n_units = b * len_v * nh, b * q * nh
    max_recs = 4 * n_units * nl * npnt
    if n_rows >= INT_MAX or max_recs >= INT_MAX:
        raise ValueError(f"msda_bwd_cuda: {n_rows} dvalue rows or "
                         f"{max_recs} records do not fit an int")
    n_tiles = -(-n_rows // BWD_SCAN_TILE)
    return (BWD_HEADER + n_rows + -(-n_units // 32) + n_tiles
            + 2 * n_units, max_recs)


def msda_bwd_cuda(value: torch.Tensor, spatial_shapes,
                  sampling_locations: torch.Tensor,
                  attention_weights: torch.Tensor,
                  grad_output: torch.Tensor) -> tuple:
    """Launch K2's backward on PyTorch's current stream: (dvalue,
    dlocations, dweights) as `msda_bwd_plain` gives them, each summed in a
    fixed order (a repeat launch gives the same bits), with scratch of
    `bwd_scratch`'s sizes. Raises unless every input, grad_output (B, Q,
    nH * D) included, is a contiguous f32 CUDA tensor of the expected
    shape; the caller makes grad_output contiguous."""
    global bwd_launches
    shapes, b, len_v, nh, d, q, nl, npnt = _checked(
        "msda_bwd_cuda", value, spatial_shapes, sampling_locations,
        attention_weights, ("grad_output", grad_output))
    if tuple(grad_output.shape) != (b, q, nh * d):
        raise ValueError(f"msda_bwd_cuda: grad_output "
                         f"{tuple(grad_output.shape)}, expected {(b, q, nh * d)}")
    dvalue = torch.empty_like(value)
    dloc = torch.empty_like(sampling_locations)
    dattn = torch.empty_like(attention_weights)
    if dloc.numel() == 0 or dvalue.numel() == 0:
        return dvalue.zero_(), dloc.zero_(), dattn.zero_()
    n_ints, n_recs = bwd_scratch(b, len_v, q, nh, nl, npnt)
    scratch = torch.empty(n_ints, dtype=torch.int32, device=value.device)
    records = torch.empty(2 * n_recs, dtype=torch.int32, device=value.device)
    launch = _library().df3d_msda_bwd_f32
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(value.data_ptr(), sampling_locations.data_ptr(),
                     attention_weights.data_ptr(), grad_output.data_ptr(),
                     dvalue.data_ptr(), dloc.data_ptr(), dattn.data_ptr(),
                     scratch.data_ptr(), n_ints, records.data_ptr(), n_recs,
                     _flat(shapes), nl, b, len_v, q, nh, d, npnt, stream)
    if err != 0:
        raise RuntimeError(f"msda_bwd_cuda: launch failed, cudaError {err}")
    bwd_launches += 1
    return dvalue, dloc, dattn
