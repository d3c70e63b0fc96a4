"""Presets and configs (port of df3d/config): `PRESETS` / `get_preset` for
the JAX package's eight preset names, YAML configs with `_base_`
inheritance (`load_config`) and `--set` dot-path overrides
(`apply_preset_overrides` on a preset, `merge_overrides` on a config)."""

from df3d_torch.config.config import (
    Config, apply_preset_overrides, load_config, merge_overrides,
)
from df3d_torch.config.presets import PRESETS, fused_config, get_preset

__all__ = ["Config", "PRESETS", "apply_preset_overrides", "fused_config",
           "get_preset", "load_config", "merge_overrides"]
