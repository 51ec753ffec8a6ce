"""Self-typing serializable config system.

The port's own copy of ``mimikit_tpu/config.py`` (it imports nothing of the
JAX package): a ``Config`` dataclass whose subclasses automatically carry a
``type`` tag (their qualified name), YAML round-trip serialization, and
polymorphic deserialization that resolves ``type`` tags back to classes.
Bare qualnames resolve against the flat ``mimikit_tpu_torch`` namespace,
which exports the same names as ``mimikit_tpu`` — so a YAML written by the
JAX package (``type: SampleRNN.Config``) loads here unchanged.
"""
from __future__ import annotations

import abc
import dataclasses as dtc
import enum
import sys
import types
import typing
from copy import deepcopy
from functools import reduce
from typing import Any, Dict, List, Optional, Tuple, Union

import yaml

__all__ = [
    "private_runtime_field",
    "Config",
    "Configurable",
]

_ROOT_PACKAGE = "mimikit_tpu_torch"


def private_runtime_field(default):
    """A dataclass field holding runtime wiring state: never serialized.

    Mirrors ``private_runtime_field`` in the reference (``config.py:16-17``).
    """
    return dtc.field(
        init=False,
        repr=False,
        metadata=dict(runtime_only=True),
        default_factory=lambda: default,
    )


def _get_type_object(type_: str) -> type:
    """Resolve a ``type`` tag to a class.

    Bare qualnames resolve against the flat ``mimikit_tpu_torch`` namespace;
    ``module:qualname`` tags resolve against that module (this is how
    user-defined configs outside the package round-trip — see the
    reference's ``tests/test_checkpointable.py``).
    """
    if ":" in type_:
        module, qualname = type_.split(":")
    else:
        module, qualname = _ROOT_PACKAGE, type_
    try:
        if module not in sys.modules:
            __import__(module)
        m = sys.modules[module]
        return reduce(lambda o, a: getattr(o, a), qualname.split("."), m)
    except (AttributeError, KeyError, ImportError):
        raise ImportError(
            f"could not find class '{qualname}' from module {module} in current environment"
        )


# Fields whose declared type is abstract: the value's concrete class is fixed
# by the key name (reference ``config.py:33-42``).
STATIC_TYPED_KEYS = {
    "dataset": "DatasetConfig",
    "io_spec": "IOSpec",
    "inputs": "InputSpec",
    "targets": "TargetSpec",
    "objective": "Objective",
    "extractor": "Extractor",
    "activation": "ActivationConfig",
}
# keys holding a *tuple* of statically-typed values
STATIC_TYPED_SEQ_KEYS = {
    "extractors": "Extractor",
    "inputs": "InputSpec",
    "targets": "TargetSpec",
    "extra_loss_terms": "Objective",
}


def _is_runtime_field(f: dtc.Field) -> bool:
    return bool(f.metadata.get("runtime_only", False))


def _structure_value(v):
    """Convert a config value into plain YAML-safe python objects."""
    if isinstance(v, enum.Enum):
        return v.value
    if dtc.is_dataclass(v) and not isinstance(v, type):
        return _structure_dataclass(v)
    if isinstance(v, (tuple, list)):
        return [_structure_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _structure_value(x) for k, x in v.items()}
    if isinstance(v, float) and v == float("inf"):
        return ".inf"
    if isinstance(v, float) and v == float("-inf"):
        return "-.inf"
    return v


def _structure_dataclass(obj) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    # leading type tag (matches the reference's field ordering)
    if hasattr(obj, "type") and isinstance(getattr(obj, "type", None), str):
        out["type"] = obj.type
    for f in dtc.fields(obj):
        if f.name == "type" or _is_runtime_field(f):
            continue
        out[f.name] = _structure_value(getattr(obj, f.name))
    return out


def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is Union or origin is getattr(types, "UnionType", None):
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce_to_annotation(value, tp):
    """Best-effort coercion of a YAML-loaded value to a field annotation."""
    if value is None:
        return None
    tp = _unwrap_optional(tp)
    origin = typing.get_origin(tp)
    if isinstance(tp, type) and dtc.is_dataclass(tp) and isinstance(value, dict):
        return Config.object(value, as_type=tp)
    if isinstance(tp, type) and issubclass(tp, enum.Enum) and isinstance(value, str):
        return tp(value)
    if origin in (tuple, Tuple):
        args = typing.get_args(tp)
        if isinstance(value, (list, tuple)):
            if args and args[-1] is Ellipsis:
                return tuple(_coerce_to_annotation(v, args[0]) for v in value)
            if args:
                return tuple(
                    _coerce_to_annotation(v, a) for v, a in zip(value, args)
                )
            return tuple(value)
    if origin in (list, List) and isinstance(value, (list, tuple)):
        args = typing.get_args(tp)
        if args:
            return [_coerce_to_annotation(v, args[0]) for v in value]
        return list(value)
    if tp is float and isinstance(value, str) and value in (".inf", "-.inf", "inf", "-inf"):
        return float(value.replace(".inf", "inf"))
    if tp is float and isinstance(value, int):
        return float(value)
    return value


@dtc.dataclass
class Config:
    """Base class for every serializable configuration object.

    Subclasses get a ``type: str`` field holding their qualified name unless
    declared with ``type_field=False`` (reference ``config.py:49-64``).
    """

    @classmethod
    def __init_subclass__(cls, type_field=True, **kwargs):
        super().__init_subclass__(**kwargs)
        if type_field:
            default = f"{cls.__qualname__}"
            if not cls.__module__.startswith(_ROOT_PACKAGE):
                default = f"{cls.__module__}:{default}"
            setattr(cls, "type", dtc.field(init=False, default=default, repr=False))
            if "__annotations__" in cls.__dict__:
                ann = cls.__dict__["__annotations__"].copy()
                for k in ann:
                    cls.__dict__["__annotations__"].pop(k)
                cls.__dict__["__annotations__"].update({"type": str, **ann})
            else:
                setattr(cls, "__annotations__", {"type": str})

    @staticmethod
    def validate_class(cls: type):
        if "__dataclass_fields__" not in cls.__dict__:
            if not issubclass(cls, (tuple, list)):
                raise TypeError(
                    "Please decorate your Config class with @dataclass"
                    " so that it can be (de)serialized"
                )

    @property
    def owner_class(self):
        """Map a nested ``Net.Config`` class back to ``Net``
        (reference ``config.py:73-78``)."""
        module, type_ = type(self).__module__, type(self).__qualname__
        type_ = ".".join(type_.split(".")[:-1]) if "." in type_ else type_
        type_ = f"{module}:{type_}"
        return _get_type_object(type_)

    def serialize(self) -> str:
        self.validate_class(type(self))
        return yaml.safe_dump(
            _structure_dataclass(self), sort_keys=False, default_flow_style=False
        )

    @staticmethod
    def deserialize(raw_yaml: str, as_type: Optional[type] = None):
        cfg = yaml.safe_load(raw_yaml)
        if as_type is None and isinstance(cfg, dict) and "type" in cfg:
            as_type = _get_type_object(cfg["type"])
        return Config.object(cfg, as_type)

    @staticmethod
    def object(cfg, as_type: Optional[type] = None):
        """Reconstruct a typed object tree from plain dicts/lists
        (reference ``config.py:92-118``)."""
        if isinstance(cfg, dict):
            cfg = dict(cfg)
            # resolve statically-typed keys first
            for k, v in list(cfg.items()):
                if k in STATIC_TYPED_SEQ_KEYS and isinstance(v, (list, tuple)):
                    cls = _get_type_object(STATIC_TYPED_SEQ_KEYS[k])
                    cfg[k] = tuple(Config.object(x, as_type=cls) for x in v)
                elif k in STATIC_TYPED_KEYS and isinstance(v, dict):
                    cls = _get_type_object(STATIC_TYPED_KEYS[k])
                    cfg[k] = Config.object(v, as_type=cls)
                elif isinstance(v, (dict, list, tuple)):
                    cfg[k] = Config.object(v)

            type_tag = cfg.pop("type", None)
            if type_tag is not None and as_type is None:
                cls = _get_type_object(type_tag)
            elif as_type is not None:
                cls = as_type
            else:
                return cfg  # untyped raw dict
            return _instantiate(cls, cfg)

        elif isinstance(cfg, (list, tuple)):
            return [Config.object(x, as_type=as_type) for x in cfg]
        return cfg

    def dict(self):
        """caution! nested configs are also converted!"""
        return dtc.asdict(self)

    def copy(self):
        return deepcopy(self)

    def validate(self) -> Tuple[bool, str]:
        return True, ""


def _field_hints(cls: type) -> Dict[str, Any]:
    """Resolved field annotations for ``cls``.

    ``typing.get_type_hints`` raises when any annotation is an unresolvable
    forward reference (common under ``from __future__ import annotations``
    when the name is only imported for type checking).  Falling back to the
    raw *string* annotations would silently disable tuple/enum/float
    coercion — the reference's OmegaConf path always materializes declared
    ``Tuple`` fields as tuples, so a loaded config must too.  Resolve
    per-field instead, against each base's module globals plus the package
    namespace, and keep whatever still fails as-is (no coercion for that
    field only)."""
    try:
        return typing.get_type_hints(cls)
    except Exception:
        pass
    pkg = sys.modules.get(_ROOT_PACKAGE)
    extra = vars(pkg) if pkg is not None else {}
    hints: Dict[str, Any] = {}
    for base in reversed(cls.__mro__):
        mod = sys.modules.get(base.__module__)
        mod_globals = getattr(mod, "__dict__", {})
        for name, ann in getattr(base, "__annotations__", {}).items():
            if isinstance(ann, str):
                try:
                    ann = eval(  # noqa: S307 — class-authored annotations
                        ann, {**vars(typing), **mod_globals, **extra}
                    )
                except Exception:
                    pass
            hints[name] = ann
    return hints


def _instantiate(cls: type, data: Dict[str, Any]):
    """Build ``cls(**data)``, coercing values to field annotations."""
    if not dtc.is_dataclass(cls):
        return cls(**data)
    hints = _field_hints(cls)
    init_fields = {f.name for f in dtc.fields(cls) if f.init}
    kwargs = {}
    post_set = {}
    for k, v in data.items():
        tp = hints.get(k, Any)
        coerced = _coerce_to_annotation(v, tp) if not _is_config_instance(v) else v
        if k in init_fields:
            kwargs[k] = coerced
        else:
            post_set[k] = coerced
    obj = cls(**kwargs)
    for k, v in post_set.items():
        try:
            setattr(obj, k, v)
        except Exception:
            pass
    return obj


def _is_config_instance(v) -> bool:
    return dtc.is_dataclass(v) and not isinstance(v, type)


class Configurable(abc.ABC):
    @classmethod
    @abc.abstractmethod
    def from_config(cls, config: Config):
        ...

    @property
    @abc.abstractmethod
    def config(self) -> Config:
        ...
