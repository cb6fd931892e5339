"""A reader for the subset of YAML the recipes are written in, with
PyYAML's `safe_load` typing, so that a recipe loads where no YAML package
is installed.

The subset:

- block mappings nested by indentation (spaces only), one `key: value` or
  `key:` per line, keys plain words;
- scalars: plain, or quoted on one line ('...' with '' for a quote, or
  "..." without escapes);
- flow lists of scalars on one line: `[8, 8]`, `[]`;
- `#` comments, at the start of a line or after a blank.

Plain scalars are typed as PyYAML's YAML 1.1 resolver types them:
`null`/`~`/nothing is None; `true`/`yes`/`on` and `false`/`no`/`off` (in
lower, capitalised or upper case) are booleans; decimal integers are ints;
a float needs a dot and, with an exponent, a signed one (`1.0e-9` is a
float, `1e-9` a string), plus `.inf`, `-.inf` and `.nan`. Everything else
PyYAML would read differently from a plain string (octal, hexadecimal,
binary or sexagesimal numbers, numbers with `_`, timestamps, the `<<` and
`=` keys) raises, as does any syntax outside the subset: anchors, aliases,
tags, block lists, block scalars, flow mappings, multi-line flow lists or
quoted scalars, documents markers, tabs, duplicate keys. The reader never
guesses: what it returns equals `yaml.safe_load` of the same text.

    data = load(open("recipes/Synthetic/hard_synthetic.yaml").read())
    value = parse_value("[0.9, 0.98]")       # -> [0.9, 0.98]
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# PyYAML's own int, float and timestamp resolvers, and its merge and value
# keys: a plain scalar they match that the patterns above do not is typed
# by PyYAML in a way this reader does not reproduce
_PYYAML_INT = re.compile(
    r"(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_PYYAML_FLOAT = re.compile(
    r"(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_PYYAML_TIMESTAMP = re.compile(
    r"(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]"
    r":[0-9][0-9](?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_PYYAML_SPECIAL = ("<<", "=")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*$")
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"


class YamlLiteError(ValueError):
    """Text outside the subset this reader takes."""


def _fail(lineno: int, msg: str) -> None:
    raise YamlLiteError(f"line {lineno}: {msg}")


def _strip_comment(line: str) -> str:
    """The line without its comment; quotes are scanned so a `#` inside one
    stays."""
    quote = None
    for i, ch in enumerate(line):
        if quote is not None:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _quoted(text: str, lineno: int) -> str:
    quote = text[0]
    body = text[1:]
    if quote == "'":
        out, i = [], 0
        while i < len(body):
            if body[i] == "'":
                if body[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                if body[i + 1:].strip():
                    _fail(lineno, f"text after a quoted scalar: {text!r}")
                return "".join(out)
            out.append(body[i])
            i += 1
    else:
        end = body.find('"')
        if end >= 0:
            if "\\" in body[:end]:
                _fail(lineno, f"escapes in double-quoted scalars are not read: {text!r}")
            if body[end + 1:].strip():
                _fail(lineno, f"text after a quoted scalar: {text!r}")
            return body[:end]
    _fail(lineno, f"a quoted scalar must end on its line: {text!r}")


def _plain(text: str, lineno: int, in_flow: bool = False) -> Any:
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    m = _INF.match(text)
    if m:
        return float(m.group(1) + "inf")
    if _NAN.match(text):
        return float("nan")
    if (_PYYAML_INT.match(text) or _PYYAML_FLOAT.match(text)
            or _PYYAML_TIMESTAMP.match(text) or text in _PYYAML_SPECIAL):
        _fail(lineno, f"{text!r} is a value PyYAML types in a way this reader does not "
                      "(octal, hexadecimal, binary, sexagesimal, with '_', a timestamp or a "
                      "merge key); quote it")
    if text[0] in _INDICATORS or text[0] in " \t":
        _fail(lineno, f"{text!r} starts with an indicator outside the subset (a flow "
                      "mapping, anchor, alias, tag, block scalar or block list)")
    if ": " in text or text.endswith(":") or " #" in text:
        _fail(lineno, f"{text!r}: a mapping or comment inside a plain scalar")
    if in_flow and any(ch in text for ch in ",[]{}"):
        _fail(lineno, f"{text!r}: flow indicators inside a flow list item")
    return text


def _scalar(text: str, lineno: int, in_flow: bool = False) -> Any:
    if text[:1] in ("'", '"'):
        return _quoted(text, lineno)
    return _plain(text, lineno, in_flow)


def _value(text: str, lineno: int) -> Any:
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            _fail(lineno, f"a flow list must end on its line: {text!r}")
        inner = text[1:-1].strip()
        if not inner:
            return []
        if "'" in inner or '"' in inner:
            _fail(lineno, f"quoted items in flow lists are not read: {text!r}")
        items = [item.strip() for item in inner.split(",")]
        if any(not item for item in items):
            _fail(lineno, f"an empty item in a flow list: {text!r}")
        return [_scalar(item, lineno, in_flow=True) for item in items]
    return _scalar(text, lineno)


def parse_value(text: str) -> Any:
    """One value as it would follow `key: ` in a recipe (a scalar or a flow
    list), typed as `yaml.safe_load` types it."""
    return _value(text, 1)


def load(text: str) -> Any:
    """The document `text` as `yaml.safe_load` gives it: a dict of nested
    dicts, lists and scalars, or None for an empty document."""
    lines: List[Tuple[int, int, str]] = []   # (line number, indent, content)
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            _fail(lineno, "tabs in indentation")
        content = _strip_comment(raw)
        if not content.strip():
            continue
        if content.startswith(("---", "...")) and content[3:4] in ("", " "):
            _fail(lineno, "document markers are outside the subset")
        indent = len(content) - len(content.lstrip(" "))
        lines.append((lineno, indent, content.strip()))
    if not lines:
        return None
    if lines[0][1] != 0:
        _fail(lines[0][0], "the document must start at column 0")
    root, pos = _mapping(lines, 0, 0)
    if pos != len(lines):
        _fail(lines[pos][0], "indentation does not match any open mapping")
    return root


def _mapping(lines, pos: int, indent: int):
    out = {}
    while pos < len(lines):
        lineno, ind, content = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            _fail(lineno, "unexpected indentation")
        if content.startswith("- ") or content == "-":
            _fail(lineno, "block lists are outside the subset")
        key, sep, rest = content.partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            _fail(lineno, f"expected 'key: value', got {content!r}")
        if (not _KEY.match(key) or key in _NULL or key in _TRUE or key in _FALSE
                or _INT.match(key) or _FLOAT.match(key)):
            _fail(lineno, f"key {key!r} is not a plain word")
        if key in out:
            _fail(lineno, f"duplicate key {key!r}")
        rest = rest.strip()
        pos += 1
        if rest:
            out[key] = _value(rest, lineno)
            if pos < len(lines) and lines[pos][1] > indent:
                _fail(lines[pos][0], f"indented lines after the value of {key!r}")
        elif pos < len(lines) and lines[pos][1] > indent:
            out[key], pos = _mapping(lines, pos, lines[pos][1])
        else:
            out[key] = None
    return out, pos
