"""Config overrides for the port's frozen dataclass configs (port of
custom_diffusion360_tpu/utils/config.py):

    cfg = load_config(EngineConfig(), "run.yaml", ["unet.num_samples=16"])

A YAML file (read with PyYAML, imported only when a file is given) and
``key.path=value`` dotlist strings share one override path. Dotlist values
are parsed here without PyYAML, with YAML 1.1's scalar rules as
``yaml.safe_load`` applies them: ints (``16``, ``0x10``, ``1_000``),
floats (``1.5``, ``1.0e-4``, ``.inf``), bools (``true``, ``yes``, ``off``),
``null``/``~``, quoted strings, flow lists ``[1, 2]`` and flow maps
``{a: 1}``; anything else is the string itself.

One deviation from the JAX package: YAML 1.1 reads ``1e-4`` (no dot) as
the string "1e-4". Where the field being set holds a float, such a string
is converted to that float here; the JAX package stores the string.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Iterable, Mapping, Optional

_BOOL = {s: v for v, words in ((True, ("yes", "true", "on")), (False, ("no", "false", "off")))
         for w in words for s in (w, w.capitalize(), w.upper())}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"""[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)
                      |[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""", re.X)
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                        |\.[0-9_]+(?:[eE][-+][0-9]+)?
                        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                        |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)""", re.X)


def _sexagesimal(digits: str, cast):
    value, base = 0, 1
    for part in reversed(digits.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _int(s: str) -> int:
    s = s.replace("_", "")
    sign = -1 if s[0] == "-" else 1
    s = s.lstrip("+-")
    if s == "0":
        return 0
    if s.startswith("0b"):
        return sign * int(s[2:], 2)
    if s.startswith("0x"):
        return sign * int(s[2:], 16)
    if s.startswith("0"):
        return sign * int(s, 8)
    if ":" in s:
        return sign * _sexagesimal(s, int)
    return sign * int(s)


def _float(s: str) -> float:
    s = s.replace("_", "").lower()
    sign = -1.0 if s[0] == "-" else 1.0
    s = s.lstrip("+-")
    if s == ".inf":
        return sign * float("inf")
    if s == ".nan":
        return float("nan")
    if ":" in s:
        return sign * _sexagesimal(s, float)
    return sign * float(s)


def _plain(s: str):
    """One plain (unquoted) scalar, resolved as YAML 1.1 resolves it."""
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.fullmatch(s):
        return _int(s)
    if _FLOAT.fullmatch(s):
        return _float(s)
    return s


def _quoted(s: str) -> str:
    if s[0] == "'":
        return s[1:-1].replace("''", "'")
    return s[1:-1].encode("latin-1", "backslashreplace").decode("unicode_escape")


def _split_flow(body: str) -> list:
    """Split a flow collection's body on the commas at its own depth."""
    parts, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(body[start:i])
            start = i + 1
    parts.append(body[start:])
    parts = [p.strip() for p in parts]
    if parts and parts[-1] == "":  # a trailing comma
        parts.pop()
    return parts


def _value(s: str):
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return _quoted(s)
    if s.startswith("[") and s.endswith("]"):
        return [_value(p) for p in _split_flow(s[1:-1])]
    if s.startswith("{") and s.endswith("}"):
        out = {}
        for p in _split_flow(s[1:-1]):
            key, sep, val = p.partition(": ")
            if not sep and p.endswith(":"):
                key, val = p[:-1], ""
            out[_value(key)] = _value(val)
        return out
    return _plain(s)


def _parse_scalar(s: str):
    """A dotlist value, as ``yaml.safe_load`` reads it (see the module
    docstring for the forms taken); no PyYAML needed."""
    return _value(s)


def _coerce(cur, value):
    if isinstance(cur, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(cur, float) and isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            return value
    return value


def _replace_path(cfg, path: list, value):
    """Immutable nested dataclasses.replace along a dotted path."""
    field = path[0]
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"cannot descend into {type(cfg).__name__} at {field!r}")
    names = {f.name for f in dataclasses.fields(cfg)}
    if field not in names:
        raise KeyError(f"unknown config field {field!r} on {type(cfg).__name__} "
                       f"(valid: {sorted(names)})")
    cur = getattr(cfg, field)
    if len(path) == 1:
        if dataclasses.is_dataclass(cur) and isinstance(value, Mapping):
            new = _merge_mapping(cur, value)
        else:
            new = _coerce(cur, value)
    else:
        new = _replace_path(cur, path[1:], value)
    return dataclasses.replace(cfg, **{field: new})


def _merge_mapping(cfg, mapping: Mapping):
    for k, v in mapping.items():
        cfg = _replace_path(cfg, k.split("."), v)
    return cfg


def apply_overrides(cfg, overrides: Iterable[str]):
    """Dotlist overrides: ["unet.num_samples=16", "loss.loss_fg_lambda=5"]."""
    for item in overrides or ():
        key, _, raw = item.partition("=")
        cfg = _replace_path(cfg, key.strip().split("."), _parse_scalar(raw.strip()))
    return cfg


def load_config(cfg, yaml_path: Optional[str] = None, overrides: Iterable[str] = ()):
    """``cfg`` with the YAML file's mapping merged in, then ``overrides``."""
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        cfg = _merge_mapping(cfg, data)
    return apply_overrides(cfg, overrides)


def config_to_dict(cfg) -> Any:
    """Recursively serialize for logging and saving (tuples -> lists)."""
    if dataclasses.is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, tuple):
        return [config_to_dict(x) for x in cfg]
    return cfg
