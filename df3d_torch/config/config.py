"""YAML configs and dot-path overrides (port of df3d/config/config.py).

Configs are nested dicts loaded from YAML with `_base_` inheritance (the
`_BASE_CONFIG_` spelling too; paths relative to the file, merged deeply),
and `--set a.b=value` overrides apply to a config (`merge_overrides`) or to
a preset's dataclasses (`apply_preset_overrides`). Values parse as YAML.
PyYAML is imported by the functions that parse, so the rest of the port
does not need it.
"""

from __future__ import annotations

import copy
import dataclasses
import pathlib
from typing import Any, Mapping


class Config(dict):
    """Dict with attribute access (EasyDict-style, recursion on getattr)."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config(v)
        return v

    def __setattr__(self, k, v):
        self[k] = v


def _deep_merge(base: dict, new: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in new.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str | pathlib.Path) -> Config:
    """The YAML file at `path`, its `_base_` (or `_BASE_CONFIG_`) files,
    one path or a list, merged under it first."""
    import yaml

    path = pathlib.Path(path)
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    base_key = "_base_" if "_base_" in cfg else "_BASE_CONFIG_"
    if base_key in cfg:
        bases = cfg.pop(base_key)
        if isinstance(bases, str):
            bases = [bases]
        merged: dict = {}
        for b in bases:
            bp = pathlib.Path(b)
            if not bp.is_absolute():
                bp = path.parent / bp
            merged = _deep_merge(merged, load_config(bp))
        cfg = _deep_merge(merged, cfg)
    return Config(cfg)


def _parse_value(s: str) -> Any:
    import yaml

    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def _set_path(obj, parts, value):
    if not parts:
        if isinstance(obj, tuple) and isinstance(value, list):
            return tuple(value)
        return value
    head = parts[0]
    if isinstance(obj, dict):
        if head not in obj:
            raise KeyError(f"override path {head!r} not in {sorted(obj)}")
        out = dict(obj)
        out[head] = _set_path(obj[head], parts[1:], value)
        return out
    if dataclasses.is_dataclass(obj):
        if not hasattr(obj, head):
            raise KeyError(
                f"override path {head!r} not a field of "
                f"{type(obj).__name__}"
            )
        return dataclasses.replace(
            obj, **{head: _set_path(getattr(obj, head), parts[1:], value)}
        )
    raise KeyError(
        f"cannot descend into {type(obj).__name__} at {head!r}"
    )


def apply_preset_overrides(preset, overrides: list[str]):
    """`--set a.b.c=value` overrides onto a preset: a config dataclass or a
    fused preset's dict of them. Values parse as YAML; a list becomes a
    tuple where it replaces a tuple; an unknown path, or one into anything
    but a dict or a dataclass, raises KeyError; an entry without `=`
    raises ValueError."""
    for kv in overrides:
        if "=" not in kv:
            raise ValueError(f"--set expects key=value, got {kv!r}")
        key, val = kv.split("=", 1)
        preset = _set_path(preset, key.split("."), _parse_value(val))
    return preset


def merge_overrides(cfg: Config,
                    overrides: Mapping[str, str] | list[str]) -> Config:
    """Dot-path overrides onto a config: ['model.head.nms_thresh=0.2', ...]
    or a mapping (pcdet's cfg_from_list, mmcv's DictAction). Missing
    levels are created; string values parse as YAML."""
    if isinstance(overrides, Mapping):
        items = overrides.items()
    else:
        items = [kv.split("=", 1) for kv in overrides]
    out = Config(copy.deepcopy(dict(cfg)))
    for key, val in items:
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                node[p] = nxt
            node = nxt
        node[parts[-1]] = _parse_value(val) if isinstance(val, str) else val
    return out
