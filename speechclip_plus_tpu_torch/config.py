"""Attribute-style nested configuration tree.

Pure-Python copy of ``speechclip_plus_tpu/config.py`` (the reference's
``avssl/base/ordered_namespace.py:7-153``): an ordered, attribute-accessible,
pickle-able namespace that merges YAML files, dicts, and argparse Namespaces.
Copied rather than imported so the PyTorch port never pulls in JAX.
"""
from __future__ import annotations

import argparse
import copy
from collections import OrderedDict
from types import SimpleNamespace
from typing import Any, Iterable, Mapping, Union

import yaml

__all__ = ["ConfigNode", "load_config"]


class ConfigNode:
    """Nested attribute/dict-style config.

    Accepts a dict / Namespace / list-of-those (merged sequentially), mirroring
    the reference semantics so existing SpeechCLIP+ YAML configs load verbatim.
    """

    def __init__(self, data: Union[Mapping, SimpleNamespace, argparse.Namespace, Iterable, None] = None, **kwargs):
        object.__setattr__(self, "_store", OrderedDict())
        if data is None:
            self._merge_mapping(kwargs)
        elif isinstance(data, (SimpleNamespace, argparse.Namespace)):
            self._merge_mapping(vars(data))
        elif isinstance(data, Mapping):
            self._merge_mapping(data)
        elif isinstance(data, (list, tuple)):
            for item in data:
                if isinstance(item, (SimpleNamespace, argparse.Namespace)):
                    item = vars(item)
                elif isinstance(item, ConfigNode):
                    item = item.to_dict()
                self._merge_mapping(item)
        else:
            raise TypeError(f"Cannot build ConfigNode from {type(data)}")

    # -- construction helpers -------------------------------------------------
    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, ConfigNode):
            return value
        if isinstance(value, Mapping):
            return ConfigNode(value)
        if isinstance(value, (SimpleNamespace, argparse.Namespace)):
            return ConfigNode(vars(value))
        if isinstance(value, list):
            return [ConfigNode._wrap(v) if isinstance(v, (Mapping, SimpleNamespace, argparse.Namespace)) else v for v in value]
        return value

    def _merge_mapping(self, data: Mapping) -> None:
        for key, value in data.items():
            self._store[key] = self._wrap(value)

    # -- attribute / item protocol -------------------------------------------
    def __getattr__(self, key: str) -> Any:
        store = object.__getattribute__(self, "_store")
        if key in store:
            return store[key]
        raise AttributeError(key)

    def __setattr__(self, key: str, value: Any) -> None:
        self._store[key] = self._wrap(value)

    def __getitem__(self, key: str) -> Any:
        return self._store[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._store[key] = self._wrap(value)

    def __delitem__(self, key: str) -> None:
        del self._store[key]

    def __contains__(self, key: str) -> bool:
        return key in self._store

    def __iter__(self):
        return iter(self._store)

    def __len__(self) -> int:
        return len(self._store)

    def __eq__(self, other) -> bool:
        if isinstance(other, ConfigNode):
            return self.to_dict() == other.to_dict()
        if isinstance(other, Mapping):
            return self.to_dict() == dict(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"

    # -- pickle ---------------------------------------------------------------
    def __getstate__(self):
        return self.to_dict()

    def __setstate__(self, state):
        object.__setattr__(self, "_store", OrderedDict())
        self._merge_mapping(state)

    # -- dict protocol --------------------------------------------------------
    def keys(self):
        return self._store.keys()

    def values(self):
        return self._store.values()

    def items(self):
        return self._store.items()

    def get(self, key: str, default: Any = None) -> Any:
        return self._store.get(key, default)

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self._store:
            self[key] = default
        return self._store[key]

    def to_dict(self) -> dict:
        out = {}
        for key, value in self._store.items():
            if isinstance(value, ConfigNode):
                out[key] = value.to_dict()
            elif isinstance(value, list):
                out[key] = [v.to_dict() if isinstance(v, ConfigNode) else v for v in value]
            else:
                out[key] = value
        return out

    def copy(self) -> "ConfigNode":
        return ConfigNode(copy.deepcopy(self.to_dict()))

    def update(self, other: Union[Mapping, "ConfigNode"]) -> None:
        if isinstance(other, ConfigNode):
            other = other.to_dict()
        self._merge_mapping(other)

    def deep_update(self, other: Union[Mapping, "ConfigNode"]) -> None:
        """Recursively merge ``other`` into this node (leaves overwrite)."""
        if isinstance(other, ConfigNode):
            other = other.to_dict()
        for key, value in other.items():
            if key in self._store and isinstance(self._store[key], ConfigNode) and isinstance(value, Mapping):
                self._store[key].deep_update(value)
            else:
                self[key] = value


def load_config(path: str, *overrides: Mapping) -> ConfigNode:
    """Load a YAML config file (accepts reference SpeechCLIP+ YAMLs verbatim)."""
    with open(path, "r") as f:
        data = yaml.safe_load(f)
    node = ConfigNode(data)
    for ov in overrides:
        node.deep_update(ov)
    return node

