"""A reader of the YAML that the training options use, without PyYAML
(the card's machine has none).

`load(text)` gives what `yaml.safe_load(text)` gives for the subset that
`configs/*.yml` and `--force_yml` values are written in: block mappings
(nested by indentation, spaces only), flow lists of scalars (`[1, 4]`),
plain scalars resolved as YAML 1.1 and PyYAML resolve them (ints, with
octal, hex, binary and base-60 forms; floats, which need a dot, so `2e-4`
stays a string while `2.0e-4` is a float; booleans such as `yes`, `On` and
`false`; null as `~`, `null` or nothing), single- and double-quoted
strings on one line, comments, and one optional leading `---`. Keys are
resolved like values, and a repeated key keeps its last value, as PyYAML
does. Anything else raises a ValueError: anchors and aliases, tags, block
scalars (`|`, `>`), block sequences (`- item`), flow mappings, nested flow
lists, multi-line scalars, timestamps, merge keys and a second document.
"""

from __future__ import annotations

import math
import re

# PyYAML's implicit resolvers (yaml/resolver.py), in its order of matching
_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
_NULL = re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_UNSUPPORTED = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9]
                          |<<$|=$)""", re.X)
# characters that may not start a plain scalar (YAML's indicators)
_INDICATORS = set("&*!|>%@`{}[]#,'\"")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


class _Error(ValueError):
    pass


def _fail(lineno, msg):
    raise _Error(f"line {lineno}: {msg} (outside the YAML subset that "
                 "gsasr_torch.utils.yaml_subset reads)")


def _sexagesimal(text, conv):
    total, base = 0, 1
    for part in reversed(text.split(":")):
        total += conv(part) * base
        base *= 60
    return total


def _int(text):
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _float(text):
    text = text.replace("_", "").lower()
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * math.inf
    if text == ".nan":
        return math.nan
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _plain(text, lineno):
    """A plain scalar, resolved as PyYAML resolves it."""
    if text and (text[0] in _INDICATORS or (text[0] in "-?:" and (
            len(text) == 1 or text[1] == " "))):
        _fail(lineno, f"{text!r} starts with an indicator")
    if _UNSUPPORTED.match(text):
        _fail(lineno, f"{text!r} (a timestamp, merge key or value key)")
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _NULL.match(text) or text == "":
        return None
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    return text


def _quoted(text, pos, lineno):
    """(string, end) of the quoted scalar starting at text[pos]."""
    q = text[pos]
    out, i = [], pos + 1
    while i < len(text):
        c = text[i]
        if c == q:
            if q == "'" and text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = text[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX:
                n = _HEX[e]
                code = text[i + 2:i + 2 + n]
                if len(code) != n or not all(
                        h in "0123456789abcdefABCDEF" for h in code):
                    _fail(lineno, f"bad escape \\{e}{code}")
                out.append(chr(int(code, 16)))
                i += 2 + n
            else:
                _fail(lineno, f"escape \\{e} (or a string over lines)")
            continue
        out.append(c)
        i += 1
    _fail(lineno, "a quoted string that does not end on its line")


def _strip_comment(text, lineno):
    """`text` up to a comment (a `#` at its start or after a space),
    outside quotes, with trailing spaces removed."""
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " [,:"):
            _, i = _quoted(text, i, lineno)
            continue
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _scalar_or_list(text, lineno):
    """A value on one line: quoted, a flow list of scalars, or plain."""
    if not text:
        return None
    if text[0] in "'\"":
        value, end = _quoted(text, 0, lineno)
        if text[end:].strip():
            _fail(lineno, f"text after a quoted string: {text[end:]!r}")
        return value
    if text[0] == "[":
        if not text.endswith("]"):
            _fail(lineno, "a flow list that does not end on its line")
        inner = text[1:-1].strip()
        items = []
        pos = 0
        while inner and pos <= len(inner):
            rest = inner[pos:].lstrip()
            pos = len(inner) - len(rest)
            if rest[:1] in ("'", '"'):
                value, end = _quoted(inner, pos, lineno)
                tail = inner[end:].lstrip()
                pos = len(inner) - len(tail)
            else:
                end = inner.find(",", pos)
                end = len(inner) if end < 0 else end
                item = inner[pos:end].strip()
                if not item or any(c in item for c in "[]{}") or \
                        ": " in item or item.endswith(":"):
                    _fail(lineno, f"flow list item {item!r}")
                value = _plain(item, lineno)
                pos = end
                tail = inner[pos:]
            items.append(value)
            if not tail:
                break
            if tail[0] != ",":
                _fail(lineno, f"flow list {text!r}")
            pos = len(inner) - len(tail) + 1
            if not inner[pos:].strip():
                break  # a trailing comma, as YAML allows
        return items
    if ": " in text or text.endswith(":"):
        _fail(lineno, f"a mapping value in a plain scalar: {text!r}")
    return _plain(text, lineno)


def _split_key(text, lineno):
    """(key, rest) of a `key: value` or `key:` line."""
    if text[0] in "'\"":
        key, end = _quoted(text, 0, lineno)
        rest = text[end:]
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            _fail(lineno, f"no ': ' after the key: {text!r}")
        return key, rest[1:].strip()
    i = text.find(": ")
    if i < 0:
        if not text.endswith(":"):
            _fail(lineno, f"{text!r} is not a `key: value` line")
        i = len(text) - 1
    key = text[:i].rstrip()
    if not key or key == "?" or key[0] in _INDICATORS:
        _fail(lineno, f"key {key!r}")
    return _plain(key, lineno), text[i + 1:].strip()


def load(text: str):
    """What `yaml.safe_load(text)` gives, for the subset above."""
    lines = []
    started = False
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip(" \t"))]:
            _fail(lineno, "a tab in the indentation")
        body = _strip_comment(raw, lineno)
        if not body.strip():
            continue
        if body.startswith("---") and body[3:4] in ("", " "):
            if started or body[3:].strip():
                _fail(lineno, "a second document, or content after ---")
            started = True
            continue
        if body.startswith("...") and body[3:4] in ("", " "):
            _fail(lineno, "a document end marker")
        if body.startswith("%"):
            _fail(lineno, "a directive")
        started = True
        indent = len(body) - len(body.lstrip(" "))
        lines.append((lineno, indent, body.strip()))
    if not lines:
        return None
    lineno, indent, first = lines[0]
    if len(lines) == 1 and not _is_mapping_line(first):
        return _scalar_or_list(first, lineno)
    value, end = _mapping(lines, 0, indent)
    if end != len(lines):
        _fail(lines[end][0], "indentation below the document's mapping")
    return value


def _is_mapping_line(text):
    if text[0] in "'\"":
        try:
            _, end = _quoted(text, 0, 0)
        except _Error:
            return False
        return text[end:end + 1] == ":" and text[end + 1:end + 2] in ("",
                                                                       " ")
    return (": " in text or text.endswith(":")) and text[0] not in "[{"


def _mapping(lines, i, indent):
    """The mapping of the lines from i at `indent`: (dict, next index)."""
    out = {}
    while i < len(lines):
        lineno, ind, text = lines[i]
        if ind < indent:
            break
        if ind > indent:
            _fail(lineno, "unexpected indentation (a multi-line scalar?)")
        if text.startswith("- ") or text == "-":
            _fail(lineno, "a block sequence")
        if text[0] in "?{[" or text[0] in "&*!|>":
            _fail(lineno, f"{text!r}")
        key, rest = _split_key(text, lineno)
        try:
            hash(key)
        except TypeError:
            _fail(lineno, f"unhashable key {key!r}")
        i += 1
        if rest:
            if rest[0] in "&*!|>{":
                _fail(lineno, f"value {rest!r} (an anchor, alias, tag, "
                      "block scalar or flow mapping)")
            out[key] = _scalar_or_list(rest, lineno)
        elif i < len(lines) and lines[i][1] > indent:
            out[key], i = _mapping(lines, i, lines[i][1])
        else:
            out[key] = None
    return out, i
