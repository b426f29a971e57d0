"""Python-file configs with ``_base_`` inheritance.

The PyTorch package's own copy of the loader in
``pointcept_keypointdetection_tpu/utils/config.py``, cut to what the port
reads: a config is a ``.py`` file evaluated into a dict; a ``_base_`` key
(str or list of str, paths relative to the file) pulls in parent configs,
deep-merged with the child winning; ``_delete_: True`` inside a dict replaces
the base dict instead of merging.  Values are reachable as attributes.
``merge_from_dict`` applies ``--options a.b.c=v`` overrides (``DictAction``
parses them), and ``dump`` writes the merged config back as Python.
"""

from __future__ import annotations

import argparse
import ast
import copy
import os
import pprint
from typing import Any, Dict, Optional

BASE_KEY = "_base_"
DELETE_KEY = "_delete_"


class ConfigDict(dict):
    """Dict with attribute access, recursively applied."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"'ConfigDict' object has no attribute '{name}'")

    def __setattr__(self, name, value):
        self[name] = value

    def __setitem__(self, key, value):
        super().__setitem__(key, _to_config_dict(value))


def _to_config_dict(value):
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in value.items()})
    if isinstance(value, (list, tuple)):
        return type(value)(_to_config_dict(v) for v in value)
    return value


def _file2dict(filename: str) -> Dict:
    filename = os.path.abspath(os.path.expanduser(filename))
    if not os.path.isfile(filename):
        raise FileNotFoundError(f"Config file not found: {filename}")
    if not filename.endswith(".py"):
        raise ValueError(f"Only .py config files are supported, got {filename}")
    with open(filename) as f:
        source = f.read()
    try:
        ast.parse(source)
    except SyntaxError as e:
        raise SyntaxError(f"Error parsing config {filename}: {e}") from e

    namespace: Dict[str, Any] = {"__file__": filename, "os": os}
    exec(compile(source, filename, "exec"), namespace)
    cfg_dict = {
        k: v
        for k, v in namespace.items()
        if not k.startswith("__") and not isinstance(v, type(os)) and k != "os"
    }

    base_files = cfg_dict.pop(BASE_KEY, [])
    if isinstance(base_files, str):
        base_files = [base_files]
    base_dict: Dict = {}
    for base in base_files:
        parent = _file2dict(os.path.join(os.path.dirname(filename), base))
        dup = set(base_dict) & set(parent)
        if dup:
            raise KeyError(f"Duplicate keys {dup} between _base_ files of {filename}")
        base_dict.update(parent)
    if base_dict:
        cfg_dict = _merge_a_into_b(cfg_dict, base_dict)
    return cfg_dict


def _merge_a_into_b(a: Dict, b: Dict) -> Dict:
    """Merge dict ``a`` (child/override) into dict ``b`` (base). Returns a new dict."""
    b = copy.deepcopy(b)
    for key, value in a.items():
        if isinstance(value, dict) and key in b and not value.pop(DELETE_KEY, False):
            if not isinstance(b[key], dict):
                raise TypeError(
                    f"Cannot merge dict into non-dict for key `{key}`: base is "
                    f"{type(b[key])}. Add `_delete_: True` to override."
                )
            b[key] = _merge_a_into_b(value, b[key])
        else:
            if isinstance(value, dict):
                value = {k: v for k, v in value.items() if k != DELETE_KEY}
            b[key] = copy.deepcopy(value)
    return b


class Config:
    """A config facade over a nested dict with attribute access."""

    def __init__(self, cfg_dict: Optional[Dict] = None):
        object.__setattr__(self, "_cfg_dict", _to_config_dict(cfg_dict or {}))

    @staticmethod
    def fromfile(filename: str) -> "Config":
        return Config(_file2dict(filename))

    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name, value):
        self._cfg_dict[name] = value

    def __getitem__(self, key):
        return self._cfg_dict[key]

    def __contains__(self, key):
        return key in self._cfg_dict

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def merge_from_dict(self, options: Dict) -> None:
        """Apply ``{"a.b.c": v}`` overrides: deep-merged, creating missing paths."""
        option_cfg: Dict = {}
        for full_key, value in options.items():
            d = option_cfg
            parts = full_key.split(".")
            for sub in parts[:-1]:
                d = d.setdefault(sub, {})
            d[parts[-1]] = value
        merged = _merge_a_into_b(option_cfg, _plain(self._cfg_dict))
        object.__setattr__(self, "_cfg_dict", _to_config_dict(merged))

    @property
    def pretty_text(self) -> str:
        return "".join(f"{key} = {pprint.pformat(_plain(value), width=100, sort_dicts=False)}\n"
                       for key, value in self._cfg_dict.items())

    def dump(self, file: str) -> None:
        with open(file, "w") as f:
            f.write(self.pretty_text)


def _plain(value):
    """ConfigDicts back to plain containers."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    return value


class DictAction(argparse.Action):
    """argparse action for ``KEY=VALUE`` pairs; a value is a Python literal
    where it parses as one, true/false/none in any case, else a string."""

    @staticmethod
    def _parse_value(value: str):
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
        lowered = value.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("none", "null"):
            return None
        return value

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, sep, value = kv.partition("=")
            if not sep:
                raise ValueError(f"Override '{kv}' is not in KEY=VALUE form")
            options[key] = self._parse_value(value)
        setattr(namespace, self.dest, options)
