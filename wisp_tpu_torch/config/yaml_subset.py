"""A reader and writer for the subset of YAML that the app configs (``app/*/configs/*.yaml``)
use, so that the port needs no PyYAML.

The subset: nested mappings by indentation (spaces), ``#`` comments, plain and quoted
scalars and flow lists of scalars (``[1.0, 1.0, 1.0]``). A plain scalar is resolved as
PyYAML's ``safe_load`` resolves it (YAML 1.1): null (``null``, ``~``, empty), bool
(``true``/``yes``/``on`` and their opposites), int (decimal, ``0x``, ``0b``, ``0o``-less
octal), float (a dot is required: ``1.0e-08`` is a float, ``1e-8`` a string), else a string.
Anything outside the subset (block lists, flow mappings, anchors, tags, multi-line scalars)
raises ``ValueError`` naming the line.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.\-]*)\s*:(?:\s+(.*))?$")


def _error(lineno: int, msg: str) -> ValueError:
    return ValueError(f"yaml line {lineno}: {msg} (outside the subset the port reads)")


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t.startswith("-") else 1
    t = t.lstrip("+-")
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if len(t) > 1 and t.startswith("0"):
        return sign * int(t, 8)
    return sign * int(t)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    if t.endswith(".inf"):
        return -math.inf if t.startswith("-") else math.inf
    if t == ".nan":
        return math.nan
    return float(t)


def _plain(text: str, lineno: int) -> Any:
    if text[:1] and text[0] in "&*!|>{%@`":
        raise _error(lineno, f"unsupported value {text!r}")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text in _TRUE
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    return text


def _quoted(text: str, lineno: int) -> Tuple[str, str]:
    """(the string, the rest of the line) of a quoted scalar at the start of ``text``."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            esc = text[i + 1:i + 2]
            table = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0"}
            if esc not in table:
                raise _error(lineno, f"unsupported escape \\{esc}")
            out.append(table[esc])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), text[i + 1:]
        out.append(c)
        i += 1
    raise _error(lineno, "unterminated quoted scalar")


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment (a ``#`` after whitespace, outside quotes)."""
    quote = None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in ("'", '"') and (i == 0 or text[i - 1] in " [,"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _scalar(text: str, lineno: int) -> Any:
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, lineno)
        if rest.strip():
            raise _error(lineno, f"text after a quoted scalar: {rest!r}")
        return value
    return _plain(text, lineno)


def _flow_list(text: str, lineno: int) -> List[Any]:
    body = text[1:]
    if not body.endswith("]"):
        raise _error(lineno, "a flow list must close on its line")
    body = body[:-1].strip()
    items: List[Any] = []
    while body:
        if body[0] in ("'", '"'):
            value, rest = _quoted(body, lineno)
        else:
            cut = body.find(",")
            raw, rest = (body, "") if cut < 0 else (body[:cut], body[cut:])
            raw = raw.strip()
            if raw[:1] in ("[", "{"):
                raise _error(lineno, "nested flow collections")
            value = _plain(raw, lineno)
        items.append(value)
        rest = rest.strip()
        if rest and not rest.startswith(","):
            raise _error(lineno, f"unexpected {rest!r} in a flow list")
        body = rest[1:].strip()
    return items


def loads(text: str) -> Dict[str, Any]:
    """The mapping of a YAML document in the subset (an empty document gives {})."""
    root: Dict[str, Any] = {}
    stack: List[Tuple[int, Dict[str, Any]]] = [(0, root)]  # (indent of its keys, mapping)
    pending = None  # (key, mapping, indent) of a key that may open a nested mapping
    for lineno, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise _error(lineno, "tab indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        body = line.strip()
        if body in ("---", "..."):
            raise _error(lineno, "document markers")
        if body.startswith("- ") or body == "-":
            raise _error(lineno, "block lists")
        indent = len(line) - len(line.lstrip(" "))
        if pending is not None:
            key, mapping, key_indent = pending
            pending = None
            if indent > key_indent:
                mapping[key] = {}
                stack.append((indent, mapping[key]))
            else:
                mapping[key] = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise _error(lineno, "inconsistent indentation")
        m = _KEY.match(body)
        if m is None:
            raise _error(lineno, f"expected 'key: value', got {body!r}")
        mapping = stack[-1][1]
        key, value = m.group(1), m.group(2)
        if key in mapping:
            raise _error(lineno, f"duplicate key {key!r}")
        if value is None or value == "":
            pending = (key, mapping, indent)
        elif value.startswith("["):
            mapping[key] = _flow_list(value, lineno)
        else:
            mapping[key] = _scalar(value, lineno)
    if pending is not None:
        pending[1][pending[0]] = None
    return root


def load_file(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        return loads(fh.read())


def _format_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "." not in text:  # keep a float a float when read back: 1e-08 -> 1.0e-08
            text = text.replace("e", ".0e") if "e" in text else text + ".0"
        return text
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} in the yaml subset")


def dumps(data: Dict[str, Any], indent: int = 0) -> str:
    """``data`` (nested dicts of scalars and lists or tuples of scalars) in the subset."""
    lines = []
    pad = " " * indent
    for key, value in data.items():
        if isinstance(value, dict):
            if value:
                lines.append(f"{pad}{key}:")
                lines.append(dumps(value, indent + 2).rstrip("\n"))
            else:
                lines.append(f"{pad}{key}: null")
        elif isinstance(value, (list, tuple)):
            lines.append(f"{pad}{key}: [" + ", ".join(_format_scalar(x) for x in value) + "]")
        else:
            lines.append(f"{pad}{key}: {_format_scalar(value)}")
    return "\n".join(lines) + "\n"
