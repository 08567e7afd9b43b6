"""JSON serialization registry for the config DSL.

The reference serializes its entire configuration tree to JSON/YAML via Jackson
with full round-trip fidelity (reference: ``MultiLayerConfiguration#toJson`` /
``#fromJson``, heavily round-trip tested). Configs-as-data is what enables
ModelSerializer, TransferLearning mutation and hyperparameter search, so the
same property is a parity requirement here.

Every config class is a ``@dataclass`` registered under a type tag; nested
configs, enums, tuples and numpy scalars round-trip losslessly.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Dict, Type

_REGISTRY: Dict[str, Type] = {}
_TYPE_KEY = "@type"


def register(cls=None, *, name: str | None = None):
    """Class decorator: register a dataclass for polymorphic JSON round-trip."""

    def wrap(c):
        tag = name or c.__name__
        if tag in _REGISTRY and _REGISTRY[tag] is not c:
            raise ValueError(f"serde tag already registered: {tag}")
        _REGISTRY[tag] = c
        c._serde_tag = tag
        return c

    return wrap(cls) if cls is not None else wrap


def registered_class(tag: str) -> Type:
    if tag not in _REGISTRY:
        raise KeyError(f"unknown config type tag: {tag!r}")
    return _REGISTRY[tag]


def to_dict(obj: Any) -> Any:
    """Recursively convert a registered config object to JSON-compatible data."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return {_TYPE_KEY: "@enum", "enum": type(obj).__name__, "value": obj.name}
    if isinstance(obj, (list, tuple)):
        data = [to_dict(v) for v in obj]
        if isinstance(obj, tuple):
            return {_TYPE_KEY: "@tuple", "items": data}
        return data
    if isinstance(obj, dict):
        for k in obj:
            if not isinstance(k, str):
                raise TypeError(
                    f"config dict keys must be strings for JSON round-trip "
                    f"fidelity, got {type(k).__name__} key {k!r}"
                )
        return {k: to_dict(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        # Look up the tag on the exact class: an unregistered subclass must
        # not silently serialize under its parent's tag.
        tag = type(obj).__dict__.get("_serde_tag")
        if tag is None:
            raise TypeError(f"dataclass {type(obj).__name__} is not @serde.register-ed")
        out = {_TYPE_KEY: tag}
        for f in dataclasses.fields(obj):
            if not f.metadata.get("serde_skip", False):
                out[f.name] = to_dict(getattr(obj, f.name))
        return out
    # numpy / jax scalars
    if hasattr(obj, "item") and callable(obj.item):
        return obj.item()
    raise TypeError(f"cannot serialize {type(obj).__name__}: {obj!r}")


_ENUMS: Dict[str, Type] = {}


def register_enum(cls):
    """Enum decorator so enums referenced by configs can round-trip by name."""
    _ENUMS[cls.__name__] = cls
    return cls


def from_dict(data: Any) -> Any:
    """Inverse of :func:`to_dict`."""
    if data is None or isinstance(data, (bool, int, float, str)):
        return data
    if isinstance(data, list):
        return [from_dict(v) for v in data]
    if isinstance(data, dict):
        tag = data.get(_TYPE_KEY)
        if tag == "@enum":
            return _ENUMS[data["enum"]][data["value"]]
        if tag == "@tuple":
            return tuple(from_dict(v) for v in data["items"])
        if tag is not None:
            cls = registered_class(tag)
            kwargs = {
                k: from_dict(v) for k, v in data.items() if k != _TYPE_KEY
            }
            field_names = {f.name for f in dataclasses.fields(cls)}
            unknown = set(kwargs) - field_names
            if unknown:
                raise ValueError(f"unknown fields for {tag}: {sorted(unknown)}")
            return cls(**kwargs)
        return {k: from_dict(v) for k, v in data.items()}
    raise TypeError(f"cannot deserialize {type(data).__name__}: {data!r}")


def to_json(obj: Any, indent: int | None = 2) -> str:
    return json.dumps(to_dict(obj), indent=indent)


def from_json(s: str) -> Any:
    return from_dict(json.loads(s))
