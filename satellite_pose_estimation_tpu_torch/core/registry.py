"""Component registry with schema extraction and dependency injection (a
copy of the JAX package's core/registry.py).

Capability parity with R2/src/core/yaml_utils.py:43-151:
* ``@register`` snapshots a callable's signature defaults into
  GLOBAL_CONFIG[name] as a schema dict;
* ``create(name, cfg)`` instantiates from the merged config, resolving
  ``__inject__`` members (build sub-components by registered name or by an
  inline ``{type: ...}`` dict) and ``__share__`` globals (top-level scalars
  like num_classes injected into any schema that declares them).

Used both for our native components and to interpret R2-format YAML files.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional

GLOBAL_CONFIG: Dict[str, dict] = {}


def register(cls_or_fn: Callable = None, *, name: Optional[str] = None):
    """Register a class/function under its name with extracted schema."""

    def wrap(target):
        key = name or target.__name__
        if key in GLOBAL_CONFIG:
            raise ValueError(f"{key} already registered")
        schema: Dict[str, Any] = {"_target": target}
        try:
            sig = inspect.signature(target)
            for pname, p in sig.parameters.items():
                if pname in ("self", "args", "kwargs"):
                    continue
                schema[pname] = (
                    None if p.default is inspect.Parameter.empty else p.default
                )
        except (TypeError, ValueError):
            pass
        schema["_inject"] = list(getattr(target, "__inject__", []))
        schema["_share"] = list(getattr(target, "__share__", []))
        GLOBAL_CONFIG[key] = schema
        return target

    if cls_or_fn is not None:
        return wrap(cls_or_fn)
    return wrap


def create(type_or_name: str, global_cfg: Optional[dict] = None, **overrides):
    """Instantiate a registered component.

    ``global_cfg`` is the merged YAML dict; per-component kwargs come from
    global_cfg[name] merged with the schema defaults, then ``overrides``.
    """
    global_cfg = global_cfg or {}
    name = type_or_name
    if name not in GLOBAL_CONFIG:
        raise ValueError(f"component '{name}' is not registered")
    schema = GLOBAL_CONFIG[name]
    target = schema["_target"]

    kwargs: Dict[str, Any] = {
        k: v for k, v in schema.items() if not k.startswith("_")
    }
    yaml_kwargs = global_cfg.get(name, {}) or {}
    if not isinstance(yaml_kwargs, dict):
        yaml_kwargs = {}
    kwargs.update({k: v for k, v in yaml_kwargs.items() if k in kwargs})

    # __share__ globals: top-level scalars override matching schema fields.
    for s in schema["_share"]:
        if s in global_cfg:
            kwargs[s] = global_cfg[s]

    # __inject__ members: value may be a registered name (str) or an inline
    # {type: Name, ...} dict.
    for dep in schema["_inject"]:
        val = kwargs.get(dep)
        if isinstance(val, str):
            kwargs[dep] = create(val, global_cfg)
        elif isinstance(val, dict) and "type" in val:
            sub = dict(val)
            sub_type = sub.pop("type")
            sub_global = dict(global_cfg)
            sub_global[sub_type] = {**(global_cfg.get(sub_type) or {}), **sub}
            kwargs[dep] = create(sub_type, sub_global)

    kwargs.update(overrides)
    return target(**kwargs)
