"""Typed options: JSON envelope files or auto-generated CLI flags (a copy
of foundpose_tpu/utils/config.py, which the port may not import; PyYAML is
imported only when a .yaml file is read, as there: it is not a declared
dependency).

Re-design of the reference config system (reference: utils/config_util.py:
110-282, utils/json_util.py:182-449). Options are frozen dataclasses; a JSON
file holds `{"<snake_case_class_name>": {...}}` (same envelope convention as
the reference, so its config files load unchanged), or every field becomes an
argparse flag. Values are validated recursively against the annotations.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import sys
import typing
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type, TypeVar, Union

T = TypeVar("T")


def camel_to_snake(name: str) -> str:
    """GenTemplatesOpts -> gen_templates_opts. (reference: config_util.py:228-237)"""
    s = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s).lower()


def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def coerce(tp, value):
    """Recursively coerces a JSON value to the annotated type."""
    tp, optional = _unwrap_optional(tp)
    if value is None:
        if optional:
            return None
        raise TypeError(f"null not allowed for {tp}")
    origin = typing.get_origin(tp)
    if dataclasses.is_dataclass(tp):
        return from_dict(tp, value)
    if origin in (list, List):
        (item_t,) = typing.get_args(tp) or (Any,)
        return [coerce(item_t, v) for v in value]
    if origin in (tuple, Tuple):
        args = typing.get_args(tp)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(coerce(args[0], v) for v in value)
        if args:
            return tuple(coerce(a, v) for a, v in zip(args, value))
        return tuple(value)
    if origin in (dict, Dict):
        kt, vt = typing.get_args(tp) or (Any, Any)
        return {coerce(kt, k): coerce(vt, v) for k, v in value.items()}
    if tp is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)):
            return bool(value)
        raise TypeError(f"cannot coerce {value!r} to bool")
    if tp in (int, float, str):
        return tp(value)
    return value


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Dict -> dataclass with strict unknown-key and type checking.

    (reference: json_util.py:226-358 `validate_json`)
    """
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"unknown option(s) for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    hints = typing.get_type_hints(cls)
    for name, value in data.items():
        kwargs[name] = coerce(hints[name], value)
    missing = [
        f.name
        for f in fields.values()
        if f.name not in kwargs
        and f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING
    ]
    if missing:
        raise ValueError(f"missing required option(s) for {cls.__name__}: {missing}")
    return cls(**kwargs)


def merge_json(base: Any, update: Any) -> Any:
    """Recursive JSON merge: nested dicts merge key-by-key, everything else
    is replaced by `update`. (reference: utils/json_util.py:39-69)"""
    if isinstance(base, dict) and isinstance(update, dict):
        out = dict(base)
        for k, v in update.items():
            out[k] = merge_json(base[k], v) if k in base else v
        return out
    return update


def merge_json_at_path(base: Any, path: str, value: Any) -> Any:
    """Merges `value` into `base` at a dotted path, creating intermediate
    dicts (e.g. path="infer_opts.batch_size").
    (reference: utils/json_util.py:72-97)"""
    if not path:
        return merge_json(base, value)
    head, _, tail = path.partition(".")
    out = dict(base) if isinstance(base, dict) else {}
    out[head] = merge_json_at_path(out.get(head, {}), tail, value)
    return out


def _parse_set_value(raw: str) -> Any:
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw  # bare strings need no quotes


def _add_field_arg(parser: argparse.ArgumentParser, name: str, tp, default):
    tp, _ = _unwrap_optional(tp)
    origin = typing.get_origin(tp)
    flag = "--" + name.replace("_", "-")
    if tp is bool:
        parser.add_argument(flag, type=lambda s: s.lower() in ("1", "true", "yes"),
                            default=default)
    elif origin in (list, List, tuple, Tuple):
        args = typing.get_args(tp)
        item_t = args[0] if args and args[0] is not Ellipsis else str
        if item_t not in (int, float, str):
            item_t = str
        parser.add_argument(flag, nargs="*", type=item_t, default=default)
    elif tp in (int, float, str):
        parser.add_argument(flag, type=tp, default=default)
    else:
        parser.add_argument(flag, type=str, default=default)


def load_envelope_file(path: str) -> Dict[str, Any]:
    """Loads an option-envelope file — `.json` or `.yaml`/`.yml`.

    Matches the reference's file-type dispatch (reference:
    utils/config_util.py:88-109 `load_from_file`): both formats feed the
    identical validation path, so a YAML twin of a JSON config resolves to
    the same options.
    """
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)
        return {} if data is None else data
    raise ValueError(f"option file {path} must be a .json or .yaml file")


def load_opts(
    cls: Type[T], argv: Optional[Sequence[str]] = None, opts_key: Optional[str] = None
) -> T:
    """Loads options from `--opts-path <json|yaml>` or generated CLI flags.

    Layering: `--opts-extra <json>` (repeatable) deep-merges further envelope
    files over the base, and `--set dotted.path=value` (repeatable, value
    parsed as JSON) patches individual fields — the reference's json merge /
    path-merge helpers as a CLI feature.

    (reference entry point: config_util.py:240-282; merge helpers:
    json_util.py:39-97)
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    key = opts_key or camel_to_snake(cls.__name__)

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--opts-path", type=str, default=None)
    pre.add_argument("--opts-extra", type=str, action="append", default=[])
    pre.add_argument("--set", dest="set_overrides", action="append", default=[])
    known, rest = pre.parse_known_args(argv)

    if known.opts_path:
        envelope = load_envelope_file(known.opts_path)
        for extra in known.opts_extra:
            envelope = merge_json(envelope, load_envelope_file(extra))
        for item in known.set_overrides:
            path, _, raw = item.partition("=")
            # Paths are relative to the opts envelope key.
            envelope = merge_json_at_path(
                envelope, f"{key}.{path}", _parse_set_value(raw)
            )
        if key not in envelope:
            raise ValueError(f"'{key}' not found in {known.opts_path}")
        base = from_dict(cls, envelope[key])
        if rest:
            # CLI flags override JSON values.
            parser = argparse.ArgumentParser()
            parser.add_argument("--opts-path", type=str, default=None)
            parser.add_argument("--opts-extra", type=str, action="append",
                                default=[])
            parser.add_argument("--set", dest="set_overrides", action="append",
                                default=[])
            hints = typing.get_type_hints(cls)
            for f in dataclasses.fields(cls):
                _add_field_arg(parser, f.name, hints[f.name], getattr(base, f.name))
            ns = parser.parse_args(argv)
            base = dataclasses.replace(
                base, **{f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)}
            )
        return base

    parser = argparse.ArgumentParser()
    parser.add_argument("--opts-path", type=str, default=None)
    parser.add_argument("--opts-extra", type=str, action="append", default=[])
    parser.add_argument("--set", dest="set_overrides", action="append",
                        default=[])
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        # default=None so only EXPLICITLY passed flags appear in `data`
        # (dataclass defaults fill in via from_dict; layered --opts-extra
        # values must not be masked by argparse defaults).
        _add_field_arg(parser, f.name, hints[f.name], None)
    ns = parser.parse_args(argv)
    data = {
        f.name: getattr(ns, f.name)
        for f in dataclasses.fields(cls)
        if getattr(ns, f.name) is not None
    }
    # Layering without --opts-path: extras form the base envelope, explicit
    # CLI flags override them, --set patches last.
    envelope = {}
    for extra in ns.opts_extra:
        envelope = merge_json(envelope, load_envelope_file(extra))
    data = merge_json(envelope.get(key, {}), data)
    for item in ns.set_overrides:
        path, _, raw = item.partition("=")
        data = merge_json_at_path(data, path, _parse_set_value(raw))
    return from_dict(cls, data)


def save_opts(opts: Any, path: str) -> None:
    """Snapshots options next to stage outputs (reference: gen_templates.py:210)."""
    key = camel_to_snake(type(opts).__name__)
    with open(path, "w") as f:
        json.dump({key: dataclasses.asdict(opts)}, f, indent=2)
