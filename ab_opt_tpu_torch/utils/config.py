"""YAML config loading with ``"{a.b.c}"`` interpolation (the port's own
copy of ``ab_opt_tpu/utils/config.py``).

After the plain YAML load, any string of the form ``"{a.b.c}"`` is
replaced by the value at that path in the root config, so that dataset
transform options can name model fields (``antigen_size:
"{model.antigen_size}"``).
"""
from __future__ import annotations

import os
import re
from typing import Any

import yaml

_PATTERN = re.compile(r'^\{([a-zA-Z0-9_.]+)\}$')


class ConfigDict(dict):
    """Dict with attribute access (EasyDict-alike, host-side only)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj

    def get_path(self, path: str, default=None):
        node: Any = self
        for part in path.split('.'):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def _interpolate(node, root):
    if isinstance(node, dict):
        return {k: _interpolate(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root) for v in node]
    if isinstance(node, str):
        m = _PATTERN.match(node)
        if m:
            val = root.get_path(m.group(1))
            if val is not None:
                return val
    return node


def load_config(path: str):
    """Load YAML -> (ConfigDict, config_name)."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    cfg = ConfigDict.wrap(raw)
    cfg = ConfigDict.wrap(_interpolate(cfg, cfg))
    name = os.path.splitext(os.path.basename(path))[0]
    return cfg, name
