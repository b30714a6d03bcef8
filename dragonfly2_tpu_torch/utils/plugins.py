"""Plugin loading by import path: the port's copy of ``load_object``,
``require_methods`` and ``PluginError`` from dragonfly2_tpu/utils/plugins.py,
for the port's ``new_evaluator("plugin:pkg.mod:attr")``.

A spec is ``"pkg.module:attr"``, resolved at boot; a factory attr is
CALLED (with optional kwargs), anything else is used as-is. Loaded objects
are duck-checked against the interface they plug into, so a typo'd spec
fails at boot with a clear error, not at first use.
"""

from __future__ import annotations

import importlib
from typing import Any, Iterable


class PluginError(Exception):
    pass


def load_object(spec: str, *, call_factories: bool = True, **factory_kwargs: Any) -> Any:
    """Resolve "pkg.module:attr" → the attr (called if callable)."""
    module_path, sep, attr = spec.partition(":")
    if not sep or not module_path or not attr:
        raise PluginError(f"bad plugin spec {spec!r}: want 'pkg.module:attr'")
    try:
        module = importlib.import_module(module_path)
    except ImportError as e:
        raise PluginError(f"plugin module {module_path!r} not importable: {e}") from e
    try:
        obj = getattr(module, attr)
    except AttributeError as e:
        raise PluginError(f"plugin {module_path!r} has no attribute {attr!r}") from e
    if call_factories and callable(obj):
        try:
            obj = obj(**factory_kwargs)
        except Exception as e:
            raise PluginError(f"plugin factory {spec!r} raised: {e}") from e
    return obj


def require_methods(obj: Any, methods: Iterable[str], *, spec: str, kind: str) -> Any:
    """Duck-type interface check with a boot-time error message."""
    missing = [m for m in methods if not callable(getattr(obj, m, None))]
    if missing:
        raise PluginError(
            f"{kind} plugin {spec!r} ({type(obj).__name__}) lacks required "
            f"methods: {missing}"
        )
    return obj
