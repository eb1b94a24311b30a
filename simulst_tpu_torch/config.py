"""Dataclass configs with dotted CLI overrides (a copy of the pieces of
simulst_tpu/config.py the training CLI uses)."""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Type


def to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def from_dict(cls: Type, d: Dict[str, Any]):
    """Build the dataclass from a dict, coercing scalars to the field's
    annotated type (bool strings parsed, ints only from integral values)."""
    def to_bool(v):
        if isinstance(v, str):
            low = v.strip().lower()
            if low in ("true", "1", "yes"):
                return True
            if low in ("false", "0", "no"):
                return False
            raise ValueError(f"can't interpret {v!r} as bool")
        return bool(v)

    def to_int(v):
        if not isinstance(v, (int, str)) and hasattr(v, "__float__"):
            f = float(v)
            if not f.is_integer():
                raise ValueError(f"int field got non-integral value {v!r}")
        return int(v)

    coerce = {"int": to_int, "float": float, "bool": to_bool, "str": str}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k in fields:
            if isinstance(v, list):
                v = tuple(v)
            ann = fields[k].type
            name = ann if isinstance(ann, str) else getattr(ann, "__name__", "")
            if v is not None and name in coerce:
                v = coerce[name](v)
            kwargs[k] = v
    return cls(**kwargs)


def apply_overrides(cfg, overrides: Dict[str, Any]):
    """key=value overrides onto a (frozen) dataclass config."""
    d = to_dict(cfg)
    d.update(overrides)
    return from_dict(type(cfg), d)


def parse_override(s: str):
    """'key=value' with json-ish value parsing."""
    k, v = s.split("=", 1)
    try:
        v = json.loads(v)
    except json.JSONDecodeError:
        pass
    return k, v
