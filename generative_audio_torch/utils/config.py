"""Config files to nested dataclasses: YAML, TOML or JSON -> dict -> dataclass.

The port's own copy of generative_audio_tpu/utils/config.py:23-100
(load_config_file, merge_config, build_dataclass, dump_config): importing
the JAX package's utils would pull in JAX. PyYAML is imported only for a
YAML file.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import (Any, Dict, Optional, Type, TypeVar, get_args, get_origin,
                    get_type_hints)

__all__ = ["load_config_file", "merge_config", "build_dataclass",
           "dump_config"]

T = TypeVar("T")


def load_config_file(path) -> Dict[str, Any]:
    """YAML / TOML / JSON file -> dict."""
    path = Path(path)
    text = path.read_text()
    suffix = path.suffix.lower()
    if suffix in (".yaml", ".yml"):
        import yaml
        return yaml.safe_load(text)
    if suffix == ".toml":
        import tomllib
        return tomllib.loads(text)
    if suffix == ".json":
        return json.loads(text)
    raise ValueError(f"Unsupported config format: {path}")


def merge_config(base: Dict, override: Optional[Dict]) -> Dict:
    """Recursive deep-merge; override wins. Ref audio_zen/utils.py:127-180."""
    out = dict(base)
    for key, value in (override or {}).items():
        if (key in out and isinstance(out[key], dict)
                and isinstance(value, dict)):
            out[key] = merge_config(out[key], value)
        else:
            out[key] = value
    return out


def build_dataclass(cls: Type[T], data: Optional[Dict]) -> T:
    """Recursively build a (possibly nested, frozen) dataclass from a dict,
    raising on unknown keys."""
    if data is None:
        return cls()
    if not dataclasses.is_dataclass(cls):
        return data  # terminal non-dataclass annotation
    hints = get_type_hints(cls)
    unknown = set(data) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"Unknown config keys for {cls.__name__}: {unknown}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        ftype = hints.get(f.name, None)
        # unwrap Optional[X]
        if get_origin(ftype) is not None and type(None) in get_args(ftype):
            inner = [a for a in get_args(ftype) if a is not type(None)]
            if len(inner) == 1:
                ftype = inner[0]
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            value = build_dataclass(ftype, value)
        elif get_origin(ftype) is tuple and isinstance(value, list):
            value = tuple(value)
        kwargs[f.name] = value
    return cls(**kwargs)


def dump_config(config) -> Dict:
    if dataclasses.is_dataclass(config):
        return dataclasses.asdict(config)
    return dict(config)
