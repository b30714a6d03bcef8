"""Validated YAML config surface.

The port's own copy of dragonfly2_tpu/utils/config.py.

Parity with the reference's config layer: every service boots from a YAML
file parsed into a strongly-typed config struct with exhaustive defaults and
a ``Validate()`` pass that rejects bad values with a precise field path
(ref client/config/peerhost.go:176-476, scheduler/config/config.go:76-424,
417-424). Flags override file values (the reference's cobra/viper layering).

Declarative: a service config is a tree of dataclasses whose fields carry
constraints in ``field(metadata=...)`` via :func:`cfgfield`::

    @dataclass
    class SchedulerYaml:
        port: int = cfgfield(9000, minimum=1, maximum=65535)
        evaluator: str = cfgfield("base", choices=("base", "ml"))

    cfg = load_config(SchedulerYaml, "scheduler.yaml")

``load_config`` applies defaults for absent keys, rejects unknown keys,
coerces scalar types, recurses into nested dataclass sections, and raises
:class:`ConfigError` naming the dotted path of the offending field.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Type, TypeVar, get_args, get_origin, get_type_hints

T = TypeVar("T")

_META_KEY = "dfconfig"


class ConfigError(ValueError):
    """A config violation with the dotted field path."""

    def __init__(self, path: str, message: str):
        self.path = path
        super().__init__(f"config field {path!r}: {message}" if path else message)


def cfgfield(
    default: Any = dataclasses.MISSING,
    *,
    default_factory: Any = dataclasses.MISSING,
    minimum: float | None = None,
    maximum: float | None = None,
    choices: tuple | None = None,
    required: bool = False,
    help: str = "",
):
    """A dataclass field carrying validation constraints."""
    meta = {
        _META_KEY: {
            "minimum": minimum,
            "maximum": maximum,
            "choices": choices,
            "required": required,
            "help": help,
        }
    }
    if default_factory is not dataclasses.MISSING:
        return dataclasses.field(default_factory=default_factory, metadata=meta)
    if default is dataclasses.MISSING:
        return dataclasses.field(metadata=meta)
    return dataclasses.field(default=default, metadata=meta)


def _coerce_scalar(value: Any, target: type, path: str) -> Any:
    if target is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ConfigError(path, f"expected number, got {type(value).__name__}")
        return float(value)
    if target is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ConfigError(path, f"expected integer, got {type(value).__name__}")
        return value
    if target is bool:
        if not isinstance(value, bool):
            raise ConfigError(path, f"expected boolean, got {type(value).__name__}")
        return value
    if target is str:
        if not isinstance(value, str):
            raise ConfigError(path, f"expected string, got {type(value).__name__}")
        return value
    return value


def _unwrap_optional(tp: Any) -> tuple[Any, bool]:
    """X | None → (X, True); plain types → (tp, False)."""
    if get_origin(tp) is not None and type(None) in get_args(tp):
        inner = [a for a in get_args(tp) if a is not type(None)]
        if len(inner) == 1:
            return inner[0], True
    return tp, False


def _build(cls: Type[T], data: Any, path: str) -> T:
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ConfigError(path or "<root>", f"expected mapping, got {type(data).__name__}")
    hints = get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key in data:
        if key not in fields:
            known = ", ".join(sorted(fields))
            raise ConfigError(
                f"{path}.{key}" if path else str(key), f"unknown key (known: {known})"
            )
    kwargs: dict[str, Any] = {}
    for name, f in fields.items():
        fpath = f"{path}.{name}" if path else name
        meta = f.metadata.get(_META_KEY, {})
        tp, optional = _unwrap_optional(hints.get(name, Any))
        if name not in data:
            if meta.get("required"):
                raise ConfigError(fpath, "required field missing")
            if dataclasses.is_dataclass(tp) and f.default is dataclasses.MISSING and (
                f.default_factory is dataclasses.MISSING
            ):
                kwargs[name] = _build(tp, {}, fpath)  # nested section, all defaults
            continue  # dataclass default applies
        value = data[name]
        if value is None and optional:
            kwargs[name] = None
            continue
        if dataclasses.is_dataclass(tp):
            kwargs[name] = _build(tp, value, fpath)
            continue
        origin = get_origin(tp)
        if origin in (list, tuple):
            if not isinstance(value, list):
                raise ConfigError(fpath, f"expected list, got {type(value).__name__}")
            item_t = (get_args(tp) or (Any,))[0]
            items = [
                _coerce_scalar(v, item_t, f"{fpath}[{i}]") if item_t in (int, float, bool, str) else v
                for i, v in enumerate(value)
            ]
            kwargs[name] = tuple(items) if origin is tuple else items
        elif tp in (int, float, bool, str):
            kwargs[name] = _coerce_scalar(value, tp, fpath)
        else:
            kwargs[name] = value
        _check_constraints(kwargs[name], meta, fpath)
    obj = cls(**kwargs)
    validate(obj, path)
    return obj


def _check_constraints(value: Any, meta: dict, path: str) -> None:
    if value is None:
        return
    mn, mx, choices = meta.get("minimum"), meta.get("maximum"), meta.get("choices")
    if mn is not None and isinstance(value, (int, float)) and value < mn:
        raise ConfigError(path, f"{value} below minimum {mn}")
    if mx is not None and isinstance(value, (int, float)) and value > mx:
        raise ConfigError(path, f"{value} above maximum {mx}")
    if choices is not None and value not in choices:
        raise ConfigError(path, f"{value!r} not one of {list(choices)}")


def validate(obj: Any, path: str = "") -> None:
    """Re-check every constraint on an already-built config tree (catches
    programmatic mutation after load; the reference's Validate())."""
    for f in dataclasses.fields(obj):
        fpath = f"{path}.{f.name}" if path else f.name
        value = getattr(obj, f.name)
        meta = f.metadata.get(_META_KEY, {})
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            validate(value, fpath)
        else:
            _check_constraints(value, meta, fpath)
    hook = getattr(obj, "validate_extra", None)
    if callable(hook):
        hook(path)


def load_config(cls: Type[T], path: str | Path | None = None, overrides: dict | None = None) -> T:
    """Build a validated config: YAML file (optional) + override mapping
    (flags), defaults elsewhere. Overrides use flat dotted keys
    (``{"scheduling.retry_limit": 5}``) or nested dicts."""
    import yaml

    data: dict = {}
    if path is not None:
        text = Path(path).read_text()
        loaded = yaml.safe_load(text)
        if loaded is None:
            loaded = {}
        if not isinstance(loaded, dict):
            raise ConfigError("<root>", f"config file must be a mapping, got {type(loaded).__name__}")
        data = loaded
    for key, value in (overrides or {}).items():
        if value is None:
            continue
        cursor = data
        *parents, leaf = key.split(".")
        for p in parents:
            nxt = cursor.setdefault(p, {})
            if not isinstance(nxt, dict):
                cursor[p] = nxt = {}
            cursor = nxt
        cursor[leaf] = value
    return _build(cls, data, "")
