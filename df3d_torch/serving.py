"""Serving numerics profiles (port of df3d/serving.py).

A profile names the numerics a detector serves with:

- "exact": f32 everywhere, sort voxelize (the reference's semantics).
- "tpu_v5e": the JAX package's headline serving profile: the sparse-conv
  bodies with at least 32 input channels take a bf16 feature table and
  bf16 weights with f32 accumulation and give bf16 features (K1's bf16
  kernel on the card), every conv of the dense stage-4 tail rounds its
  operands to bf16 and accumulates in f32, and the 2D neck and head stay
  f32; sort voxelize.

`apply_profile(model, name)` sets a profile on one built model: each of its
`SubMConv3d` and `SparseConv3d` modules (sparse or on the dense tail) gets
the profile's conv dtype and channel gate, on any detector of the port
(the JAX package sets its profile process-wide, on every model). Nothing
process-wide changes, so two models in one process may serve in different
profiles. Each module that bf16 features reach gives the JAX package's
dtype at its output: the sparse blocks, norms and the fusion hook's sums
stay in the dtype their operands promote to, and a linear or conv layer
takes a bf16 input to its f32 weights' dtype as flax's layers promote it
(`layers.promoted`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from df3d_torch.models.layers import SparseConv3d, SubMConv3d


@dataclasses.dataclass(frozen=True)
class ServingProfile:
    name: str
    conv_dtype: str          # "float32" | "bfloat16"
    conv_min_channels: int   # sparse convs with >= this many input channels
    tail_dtype_2d: str       # the neck's and head's conv dtype
    vox_method: str          # "sort" (reference-exact) | "bitrank"


PROFILES = {
    "exact": ServingProfile(
        name="exact", conv_dtype="float32", conv_min_channels=0,
        tail_dtype_2d="float32", vox_method="sort"),
    "tpu_v5e": ServingProfile(
        name="tpu_v5e", conv_dtype="bfloat16", conv_min_channels=32,
        tail_dtype_2d="float32", vox_method="sort"),
}

# None: the conv computes in its input's dtype (f32 on every path)
_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def apply_profile(model: nn.Module, name: str) -> ServingProfile:
    """Give every sparse conv module of `model` the profile's conv dtype and
    channel gate; -> the profile."""
    p = PROFILES[name]
    dtype = _DTYPES[p.conv_dtype]
    for m in model.modules():
        if isinstance(m, (SubMConv3d, SparseConv3d)):
            m.compute_dtype = dtype
            m.min_channels = p.conv_min_channels
    return p


__all__ = ["ServingProfile", "PROFILES", "apply_profile"]
