"""YAML loading with recursive ``__include__`` composition (counterpart of
core/yaml_utils.py).

A config file may list ``__include__: [relative paths]``; includes merge
depth-first (later and outer keys win), nested dicts merge recursively.
PyYAML is imported by ``load_config`` only, so a config built from a dict
(``YAMLConfig(cfg=...)``, what the R1 CLI builds) does not need it.
"""
from __future__ import annotations

import os
from typing import Any, Dict

INCLUDE_KEY = "__include__"


def merge_dict(dst: dict, src: dict) -> dict:
    """Recursively merge src into dst (src wins); returns dst."""
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            merge_dict(dst[k], v)
        else:
            dst[k] = v
    return dst


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    path = os.path.abspath(path)
    with open(path, "r") as f:
        cfg = yaml.safe_load(f) or {}

    merged: Dict[str, Any] = {}
    base_dir = os.path.dirname(path)
    for inc in cfg.pop(INCLUDE_KEY, []) or []:
        inc_path = inc if os.path.isabs(inc) else os.path.join(base_dir, inc)
        merge_dict(merged, load_config(inc_path))
    merge_dict(merged, cfg)
    return merged
