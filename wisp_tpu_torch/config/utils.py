"""Typed dataclass configs and the command line (counterpart of wisp_tpu/config/utils.py).

The same front end as the JAX package, kept here so that the port imports nothing of it:

* ``autoconfig(*ctors)`` makes a config dataclass from a constructor's signature (several
  constructors make a union, picked by its ``constructor`` name);
* ``configure(target=...)`` marks a hand-written dataclass as the config of ``target``;
* ``instantiate(cfg, **overrides)`` builds the target, dropping keyword arguments it does
  not take;
* ``parse_config(ConfigClass, args)`` merges the command line over ``--config file.yaml``
  over the defaults. Flags name fields as ``--section.field value`` (dashes or
  underscores); a union is picked by ``constructor:`` in the yaml or ``--section.constructor``;
* ``config_to_dict`` and ``print_config`` (the yaml subset of ``yaml_subset``).

Where JAX tolerates any key it does not know, the port is strict, so that no setting is
lost on the way: a key of the yaml or the command line is a field of the config, a key the
port drops on purpose (``DROPPED_KEYS``, each with its reason), or an error. A key or a
constructor that selects what the port has not ported yet (``NOT_PORTED``,
``NOT_PORTED_CONSTRUCTORS``) raises ``NotImplementedError`` naming its ROADMAP item; it is
never dropped. A key of ``NOT_PORTED`` that the port's config lacks is dropped only where
its value is what the port does (``wandb: false``).

``parse_config`` refuses each ``NOT_PORTED`` value as it reads it. ``check_ported`` holds a
whole config tree to the same rules; ``BaseTrainer`` runs it on its own config, and an app
runs it on its parsed config to refuse before it builds anything.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import sys
import types
import typing
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from wisp_tpu_torch.config import yaml_subset

_TARGET_ATTR = "__wisp_target__"
_CTOR_ATTR = "__wisp_ctor_name__"

_PRIMITIVES = (int, float, bool, str)

# keys that the JAX package reads and the port drops on purpose, with the reason
DROPPED_KEYS: Dict[str, str] = {
    "dense_lod_matmul": "a hash-grid setting (the TPU matrix-unit layout of its dense LODs; "
                        "the port's hash grid reads it for the stochastic backward's rule "
                        "and always gathers): a grid without it, the octree grid, drops it "
                        "as JAX does",
    "gt_device": "where JAX integrates the ground truth (TPU or host); the port integrates "
                 "it on the dataset's device",
    "dataset_num_workers": "JAX's host loader processes; the port's datasets live on the "
                           "device",
    "mode": "a trainer setting that nothing in the JAX package reads either",
    "log_2d": "an SDF trainer setting that nothing in the JAX package reads either",
    "viz360_num_angles": "the tracker's 360° orbit (JAX tracker.py:195 log_360_orbit), which "
                         "nothing in the JAX package calls; the orbit is not ported",
    "viz360_radius": "the tracker's 360° orbit (JAX tracker.py:195 log_360_orbit), which "
                     "nothing in the JAX package calls; the orbit is not ported",
    "viz360_render_all_lods": "the tracker's 360° orbit, which JAX's ConfigVisCameras "
                              "carries and nothing reads; the orbit is not ported",
}

# keys whose value selects what is not ported yet: (the test on the value, what and where)
NOT_PORTED: Dict[str, Tuple[Callable[[Any], bool], str]] = {
    "early_stop": (lambda v: v is not None and float(v) > 0.0,
                   "early_stop > 0, the transmittance cull (ROADMAP Queue 1, item 5)"),
    "random_lod": (bool, "random_lod (ROADMAP Queue 1, item 5)"),
    "save_valid_imgs": (bool, "save_valid_imgs (ROADMAP Queue 1, item 5)"),
    "render_segments": (lambda v: v is not None and int(v) > 1,
                        "render_segments > 1, the segmented render (ROADMAP Queue 1, "
                        "item 5)"),
    "profile": (bool, "the trainer's profiler trace (ROADMAP Queue 1, item 4)"),
    "wandb": (bool, "wandb, which publishes to an external service (ROADMAP Queue 1, "
                    "item 1)"),
}

# constructor names of the JAX package's unions that the port has not ported yet
NOT_PORTED_CONSTRUCTORS: Dict[str, str] = {
    "NeRFSyntheticDataset": "ROADMAP Queue 1, item 5",
    "RTMVDataset": "ROADMAP Queue 1, item 5",
}


def refuse_unported(key: str, value: Any, path: str = "") -> None:
    """Raise ``NotImplementedError`` when ``key: value`` selects what is not ported yet."""
    rule = NOT_PORTED.get(key)
    if rule is not None and rule[0](value):
        raise NotImplementedError(f"{path}{key}: {value!r} selects {rule[1]}, which the "
                                  f"port does not have yet")


# ---------------------------------------------------------------------------------------------
# Config generation
# ---------------------------------------------------------------------------------------------

def _resolve_ctor(ctor) -> Tuple[Callable, str, Callable]:
    """(callable to invoke, display name, function whose signature gives the fields)."""
    if inspect.isclass(ctor):
        return ctor, ctor.__name__, ctor.__init__
    if inspect.ismethod(ctor):  # a bound classmethod such as HashGrid.from_geometric
        return ctor, f"{ctor.__self__.__name__}.{ctor.__name__}", ctor
    if inspect.isfunction(ctor):
        return ctor, ctor.__qualname__, ctor
    raise TypeError(f"autoconfig: unsupported constructor {ctor!r}")


def _field_spec(param: inspect.Parameter):
    ann = param.annotation
    if ann is inspect.Parameter.empty:
        ann = Any if param.default is inspect.Parameter.empty else type(param.default)
        if ann is type(None):
            ann = Any
    if param.default is inspect.Parameter.empty:
        return ann, dataclasses.field(default=None)
    default = param.default
    if isinstance(default, (list, dict, set)) or (
            default is not None and not isinstance(default, (*_PRIMITIVES, tuple, type(None)))
            and not isinstance(default, type)):
        return ann, dataclasses.field(default_factory=lambda d=default: d)
    return ann, dataclasses.field(default=default)


# parameters that take run-time objects, wired by ``instantiate`` overrides in code
_SKIP_PARAM_TYPES = ("blas", "grid", "nef", "tracer", "pipeline", "dataset", "transform",
                     "accelstruct", "device", "generator")


def _is_cli_type(ann) -> bool:
    """Types a yaml file or the command line can give."""
    if ann in (Any, None) or ann in _PRIMITIVES or isinstance(ann, str):
        return True
    origin = typing.get_origin(ann)
    if origin in (list, tuple, dict, set, Union, types.UnionType, typing.Literal):
        return True
    return dataclasses.is_dataclass(ann)


def autoconfig(*ctors, exclude: Sequence[str] = ()):
    """Config dataclass(es) from constructor signatures: one constructor gives one
    dataclass, several a ``Union`` of them, each carrying its constructor name."""
    configs = []
    for ctor in ctors:
        target, name, sig_fn = _resolve_ctor(ctor)
        sig = inspect.signature(sig_fn)
        hints = typing.get_type_hints(sig_fn)
        fields = []
        for pname, param in sig.parameters.items():
            if pname in ("self", "cls") or pname in exclude or pname in _SKIP_PARAM_TYPES:
                continue
            if param.kind in (inspect.Parameter.VAR_POSITIONAL,
                              inspect.Parameter.VAR_KEYWORD):
                continue
            if pname in hints:
                param = param.replace(annotation=hints[pname])
            ann, fld = _field_spec(param)
            if _is_cli_type(ann):
                fields.append((pname, ann, fld))
        cfg_cls = dataclasses.make_dataclass("Config" + name.replace(".", "_"), fields)
        setattr(cfg_cls, _TARGET_ATTR, target)
        setattr(cfg_cls, _CTOR_ATTR, name)
        cfg_cls.__doc__ = f"Config of {name}, made from its signature"
        configs.append(cfg_cls)
    if len(configs) == 1:
        return configs[0]
    return Union[tuple(configs)]


def configure(target: Optional[Callable] = None, name: Optional[str] = None):
    """Mark a hand-written dataclass as the config of ``target``; ``name`` is the name a
    yaml ``constructor:`` selects it by."""
    def wrap(cls):
        cls = dataclasses.dataclass(cls)
        if target is not None:
            setattr(cls, _TARGET_ATTR, target)
            setattr(cls, _CTOR_ATTR, name or getattr(target, "__name__", str(target)))
        return cls
    return wrap


def get_config_target(cfg) -> Optional[Callable]:
    return getattr(type(cfg), _TARGET_ATTR, None)


def instantiate(cfg, **overrides):
    """Build the config's target from its fields and ``overrides`` (which win); keyword
    arguments the target does not take are dropped."""
    target = get_config_target(cfg)
    if target is None:
        raise ValueError(f"Config {type(cfg).__name__} has no build target")
    kwargs = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kwargs.update(overrides)
    sig = inspect.signature(target.__init__ if inspect.isclass(target) else target)
    if not any(p.kind == inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
        valid = set(sig.parameters) - {"self", "cls"}
        kwargs = {k: v for k, v in kwargs.items() if k in valid}
    return target(**kwargs)


# ---------------------------------------------------------------------------------------------
# Parsing: command line > yaml > defaults
# ---------------------------------------------------------------------------------------------

def _resolved_fields(cls):
    """The dataclass's fields with their annotations resolved to types."""
    hints = typing.get_type_hints(cls)
    return [(f, hints.get(f.name, f.type)) for f in dataclasses.fields(cls)]


def _union_variants(ann) -> Optional[List[type]]:
    if typing.get_origin(ann) in (Union, types.UnionType):
        variants = [a for a in typing.get_args(ann) if a is not type(None)]
        if variants and all(dataclasses.is_dataclass(v) for v in variants):
            return variants
    return None


def _coerce(value, ann):
    """A yaml or command-line value as the annotated type."""
    if value is None:
        return None
    origin = typing.get_origin(ann)
    if origin in (Union, types.UnionType):
        for a in [a for a in typing.get_args(ann) if a is not type(None)]:
            try:
                return _coerce(value, a)
            except (ValueError, TypeError):
                continue
        return value
    if origin is typing.Literal:
        for c in typing.get_args(ann):
            if value == c or str(value) == str(c):
                return c
        raise ValueError(f"{value!r} not in {typing.get_args(ann)}")
    if ann is bool or (isinstance(value, str) and ann is Any
                       and value.lower() in ("true", "false")):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            if value.lower() in ("true", "1", "yes", "on"):
                return True
            if value.lower() in ("false", "0", "no", "off"):
                return False
            raise ValueError(f"cannot parse a bool from {value!r}")
        return bool(value)
    if ann in (int, float, str):
        return ann(value)
    if origin in (list, typing.List, typing.Sequence, Sequence, set):
        (elem,) = typing.get_args(ann) or (Any,)
        if isinstance(value, str):
            value = [v for v in value.replace(",", " ").split() if v]
        return [_coerce(v, elem) for v in value]
    if origin in (tuple, typing.Tuple):
        elems = typing.get_args(ann)
        if isinstance(value, str):
            value = [v for v in value.replace(",", " ").split() if v]
        if elems and elems[-1] is Ellipsis:
            return tuple(_coerce(v, elems[0]) for v in value)
        if elems:
            return tuple(_coerce(v, e) for v, e in zip(value, elems))
        return tuple(value)
    if isinstance(value, str) and ann is Any:
        for caster in (int, float):
            try:
                return caster(value)
            except ValueError:
                pass
    return value


def _build_default(cls):
    """The config dataclass at its defaults (fields without one are None; a union takes
    its first variant)."""
    kwargs = {}
    for f, ftype in _resolved_fields(cls):
        variants = _union_variants(ftype)
        if variants is not None:
            kwargs[f.name] = _build_default(variants[0])
        elif dataclasses.is_dataclass(ftype):
            kwargs[f.name] = _build_default(ftype)
        elif f.default is not dataclasses.MISSING:
            kwargs[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            kwargs[f.name] = f.default_factory()  # type: ignore[misc]
        else:
            kwargs[f.name] = None
    return cls(**kwargs)


def _ctor_name(cls) -> str:
    return getattr(cls, _CTOR_ATTR, cls.__name__)


def _select_variant(variants: List[type], name: str) -> type:
    norm = str(name).replace("-", "_").lower()
    for v in variants:
        ctor = _ctor_name(v).replace("-", "_").lower()
        if ctor == norm or ctor.endswith("." + norm) or ctor.split(".")[0] == norm:
            return v
    for unported, item in NOT_PORTED_CONSTRUCTORS.items():
        if unported.replace("-", "_").lower() == norm:
            raise NotImplementedError(f"constructor {name!r} is not ported yet ({item})")
    raise ValueError(f"Unknown constructor {name!r}; choices: "
                     f"{[_ctor_name(v) for v in variants]}")


def _apply_dict(cfg, data: Dict[str, Any], path: str = ""):
    """A copy of the config tree ``cfg`` with the nested dict ``data`` (from the yaml or the
    command line) applied; a ``constructor`` key picks a union's variant."""
    updates = {}
    fields = {f.name: ftype for f, ftype in _resolved_fields(type(cfg))}
    for key, val in data.items():
        if key == "constructor":
            continue
        if key not in fields:
            # a setting of the JAX package the port has no field for: refused, or dropped
            # where its value is what the port does
            refuse_unported(key, _coerce(val, Any), path)
            if key in DROPPED_KEYS or key in NOT_PORTED:
                continue
            raise ValueError(f"{path}{key}: no such setting in the port's "
                             f"{type(cfg).__name__}")
        ftype = fields[key]
        cur = getattr(cfg, key)
        variants = _union_variants(ftype)
        if variants is not None and isinstance(val, dict):
            ctor_name = val.get("constructor")
            target_cls = _select_variant(variants, ctor_name) if ctor_name else type(cur)
            base = cur if type(cur) is target_cls else _build_default(target_cls)
            updates[key] = _apply_dict(base, val, f"{path}{key}.")
        elif dataclasses.is_dataclass(cur) and isinstance(val, dict):
            if val.get("constructor") is not None:  # a one-constructor config names its own
                _select_variant([type(cur)], val["constructor"])
            updates[key] = _apply_dict(cur, val, f"{path}{key}.")
        elif isinstance(val, dict):
            raise ValueError(f"{path}{key}: a mapping where a value is expected")
        else:
            updates[key] = _coerce(val, ftype)
            refuse_unported(key, updates[key], path)
    return dataclasses.replace(cfg, **updates)


def _flatten_flags(cls, prefix: str = "") -> Dict[str, Any]:
    """Dotted flag paths of the config tree (every union variant's fields included)."""
    out = {}
    for f, ftype in _resolved_fields(cls):
        path = f"{prefix}{f.name}"
        variants = _union_variants(ftype)
        if variants is not None:
            out[f"{path}.constructor"] = True
            for v in variants:
                out.update(_flatten_flags(v, path + "."))
        elif dataclasses.is_dataclass(ftype):
            out.update(_flatten_flags(ftype, path + "."))
        else:
            out[path] = True
    return out


def _extra_flags(extra: List[str]) -> Dict[str, str]:
    """``--a.b value`` / ``--a.b=value`` pairs that argparse did not know."""
    out, i = {}, 0
    while i < len(extra):
        arg = extra[i]
        if not arg.startswith("--"):
            raise ValueError(f"unexpected argument {arg!r}")
        if "=" in arg:
            key, value = arg[2:].split("=", 1)
            i += 1
        else:
            if i + 1 >= len(extra):
                raise ValueError(f"{arg} needs a value")
            key, value = arg[2:], extra[i + 1]
            i += 2
        out[".".join(p.replace("-", "_") for p in key.split("."))] = value
    return out


def _tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def check_ported(cfg, path: str = "") -> None:
    """Raise ``NotImplementedError`` if any value of the config tree selects what is not
    ported yet (a ``NOT_PORTED`` value)."""
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            check_ported(v, f"{path}{f.name}.")
        else:
            refuse_unported(f.name, v, path)


def parse_config(config_class, args: Optional[List[str]] = None, yaml_arg: str = "--config"):
    """The config tree with the command line over the yaml over the defaults.

    Flags: ``--config path.yaml``, ``--section.field value`` (dashes or underscores), a
    union's variant by ``--section.constructor Name``; a leaf name alone where it is
    unambiguous (``--lr``)."""
    if args is None:
        args = sys.argv[1:]
    cfg = _build_default(config_class)
    flag_map = _flatten_flags(config_class)
    parser = argparse.ArgumentParser(add_help=True, allow_abbrev=False)
    parser.add_argument(yaml_arg, type=str, default=None, help="YAML config file")
    registered = set()
    for path in flag_map:
        aliases = {path, path.replace("_", "-")}
        leaf = path.split(".")[-1]
        if sum(1 for p in flag_map if p.split(".")[-1] == leaf) == 1:
            aliases |= {leaf, leaf.replace("_", "-")}
        for alias in aliases - registered:
            parser.add_argument(f"--{alias}", dest=path, type=str, default=None)
            registered.add(alias)
    ns, extra = parser.parse_known_args(args)
    yaml_dest = yaml_arg.lstrip("-").replace("-", "_")
    yaml_path = getattr(ns, yaml_dest)
    if yaml_path:
        cfg = _apply_dict(cfg, yaml_subset.load_file(yaml_path))
    flat = {p: v for p, v in vars(ns).items() if v is not None and p != yaml_dest}
    flat.update(_extra_flags(extra))
    if flat:
        cfg = _apply_dict(cfg, _tree(flat))
    return cfg


# ---------------------------------------------------------------------------------------------
# Output
# ---------------------------------------------------------------------------------------------

def config_to_dict(cfg) -> Dict[str, Any]:
    if not dataclasses.is_dataclass(cfg):
        return cfg
    out = {}
    ctor = getattr(type(cfg), _CTOR_ATTR, None)
    if ctor is not None:
        out["constructor"] = ctor
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = config_to_dict(v)
        elif isinstance(v, tuple):
            out[f.name] = list(v)
        else:
            out[f.name] = v
    return out


def print_config(cfg, file=None) -> None:
    """The whole config tree, in the yaml subset that ``parse_config`` reads back."""
    print(yaml_subset.dumps(config_to_dict(cfg)), file=file or sys.stdout)
