"""Square roots rounded as IEEE 754 says, on every host.

torch's f32 `sqrt` on the CPU does not round correctly on some hosts (an
AMD EPYC with AVX-512: an ulp off on ~17% of inputs, whatever
`ATEN_CPU_CAPABILITY` selects; tests/test_torch_ieee.py); XLA's CPU
backend and CUDA's `sqrtf` do. On a CPU tensor the root is taken in f64
and rounded once to the input's dtype, which gives the correctly rounded
f32: the root of an f32 never lies within f64's rounding error of the
midpoint between two f32s unless it is exact."""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of `x`, on the CPU and on the card."""
    if x.device.type != "cpu" or x.dtype == torch.float64:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def foreach_sqrt(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """`sqrt` of each tensor of `xs` (torch._foreach_sqrt on the card)."""
    if xs and xs[0].device.type != "cpu":
        return torch._foreach_sqrt(xs)
    return [sqrt(x) for x in xs]
