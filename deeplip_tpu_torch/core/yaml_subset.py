"""A reader for the YAML that the repo's configs use, with PyYAML's answers.

``conf/*.yaml`` hold block maps, block and flow lists, comments, and quoted
and plain scalars. :func:`load_yaml` reads exactly that subset and resolves
plain scalars by PyYAML's YAML 1.1 rules (``yaml.safe_load``):

- ``null``, ``~`` and an empty value are ``None``; ``None`` is a string;
- ``true``/``false``, ``yes``/``no`` and ``on``/``off`` (each in three
  spellings) are booleans;
- ints are decimal, ``0b`` binary, ``0`` octal, ``0x`` hex or base 60
  (``1:30``), with ``_`` separators;
- floats need a dot: ``0.00001`` is a float and ``1e-5`` a string, and an
  exponent needs its sign (``1.0e+5``; ``1.0e5`` is a string); ``.inf``
  and ``.nan`` too.

Anything else (anchors, aliases, tags, block scalars, flow maps, several
documents, dates, plain scalars over several lines, tabs in indentation)
raises :class:`YAMLSubsetError` naming the file and the line.
"""

from __future__ import annotations

import json
import re
from typing import Any, Mapping

_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {**{s: True for s in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{s: False for s in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                               "OFF")}}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YAMLSubsetError(ValueError):
    """A line outside the subset :func:`load_yaml` reads."""


def _sexagesimal(text: str, kind) -> Any:
    sign = -1 if text[0] == "-" else 1
    digits = [kind(p) for p in text.lstrip("+-").split(":")]
    value = 0
    for d in digits:
        value = value * 60 + d
    return sign * value


def resolve_plain(text: str) -> Any:
    """A plain scalar's value under PyYAML's YAML 1.1 resolvers."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        t = text.replace("_", "")
        sign, body = (-1, t[1:]) if t[0] == "-" else (1, t.lstrip("+"))
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if ":" in body:
            return sign * _sexagesimal(body, int)
        if len(body) > 1 and body[0] == "0":
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        sign, body = (-1.0, t[1:]) if t[0] == "-" else (1.0, t.lstrip("+"))
        if body == ".inf":
            return sign * float("inf")
        if body == ".nan":
            return float("nan")
        if ":" in body:
            return sign * _sexagesimal(body, float)
        return sign * float(body)
    return text


class _Reader:
    def __init__(self, text: str, source: str):
        self.source = source
        self.lines: list[tuple[int, int, str]] = []   # (line number, indent, content)
        for number, raw in enumerate(text.splitlines(), start=1):
            body = raw.rstrip()
            stripped = body.lstrip(" ")
            if stripped.startswith("\t") or ("\t" in body[:len(body) - len(stripped)]):
                self.fail(number, "a tab in the indentation")
            content = self.strip_comment(stripped, number)
            if content:
                self.lines.append((number, len(body) - len(stripped), content))
        self.pos = 0

    def fail(self, number: int, what: str):
        raise YAMLSubsetError(f"{self.source}:{number}: {what} is outside the YAML subset "
                              "that deeplip_tpu_torch.core.yaml_subset reads")

    def strip_comment(self, text: str, number: int) -> str:
        """``text`` without a trailing comment; a ``#`` inside quotes, or one
        not after a space, is part of the text."""
        quote = None
        i = 0
        while i < len(text):
            c = text[i]
            if quote:
                if c == "\\" and quote == '"':
                    i += 1
                elif c == quote:
                    if quote == "'" and text[i + 1:i + 2] == "'":
                        i += 1
                    else:
                        quote = None
            elif c in "'\"" and (i == 0 or text[i - 1] in " \t[,:-"):
                quote = c
            elif c == "#" and (i == 0 or text[i - 1] in " \t"):
                return text[:i].rstrip()
            i += 1
        return text

    # -------------------------------------------------------------- blocks
    def document(self) -> Any:
        if not self.lines:
            return None
        number, indent, content = self.lines[0]
        if content.startswith(("---", "...", "%")):
            self.fail(number, "a document marker or directive")
        if self.is_item(content):
            value = self.sequence(indent)
        elif self.split_key(content, number) is not None:
            value = self.mapping(indent)
        else:
            self.fail(number, "a scalar document")
        if self.pos < len(self.lines):
            self.fail(self.lines[self.pos][0], "a line at this indentation")
        return value

    @staticmethod
    def is_item(content: str) -> bool:
        return content == "-" or content.startswith("- ")

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.pos < len(self.lines):
            number, ind, content = self.lines[self.pos]
            if ind < indent:
                break
            if ind > indent:
                self.fail(number, "a line indented deeper than its map")
            if self.is_item(content):
                break
            split = self.split_key(content, number)
            if split is None:
                self.fail(number, "a map line without 'key: value'")
            key_text, rest = split
            key = self.scalar(key_text, number)
            if key == "<<":
                self.fail(number, "a merge key")
            self.pos += 1
            out[key] = self.value_after_key(rest, indent, number)
        return out

    def value_after_key(self, rest: str, indent: int, number: int) -> Any:
        if rest:
            return self.inline(rest, number)
        if self.pos < len(self.lines):
            _, ind, content = self.lines[self.pos]
            if ind > indent:
                return self.sequence(ind) if self.is_item(content) else self.mapping(ind)
            if ind == indent and self.is_item(content):
                return self.sequence(ind)
        return None

    def sequence(self, indent: int) -> list:
        out: list = []
        while self.pos < len(self.lines):
            number, ind, content = self.lines[self.pos]
            if ind != indent or not self.is_item(content):
                if ind > indent:
                    self.fail(number, "a line indented deeper than its list")
                break
            rest = content[1:].lstrip(" ")
            self.pos += 1
            if not rest:
                if self.pos < len(self.lines) and self.lines[self.pos][1] > indent:
                    _, ind2, c2 = self.lines[self.pos]
                    out.append(self.sequence(ind2) if self.is_item(c2) else self.mapping(ind2))
                else:
                    out.append(None)
            elif self.is_item(rest) or self.split_key(rest, number) is not None:
                # "- - x" opens a list, "- key: value" a map, at the column
                # of what follows the dash
                col = ind + (len(content) - len(rest))
                self.pos -= 1
                self.lines[self.pos] = (number, col, rest)
                out.append(self.sequence(col) if self.is_item(rest) else self.mapping(col))
            else:
                out.append(self.inline(rest, number))
        return out

    def split_key(self, content: str, number: int):
        """``(key, rest)`` of a ``key: value`` line, or None."""
        if content[0] in "'\"":
            end = self.quoted_end(content, 0, number)
            tail = content[end:]
            if tail == ":" or tail.startswith(": "):
                return content[:end], tail[1:].strip()
            return None
        if content[0] in "[{&*!|>%@`":
            return None
        for m in re.finditer(r":(?= |$)", content):
            return content[:m.start()].rstrip(), content[m.end():].strip()
        return None

    # -------------------------------------------------------------- scalars
    def inline(self, text: str, number: int) -> Any:
        if text[0] == "[":
            value, end = self.flow_list(text, 0, number)
            if text[end:].strip():
                self.fail(number, "text after a flow list")
            return value
        return self.scalar(text, number)

    def scalar(self, text: str, number: int) -> Any:
        if text[0] in "'\"":
            end = self.quoted_end(text, 0, number)
            if text[end:].strip():
                self.fail(number, "text after a quoted scalar")
            return self.unquote(text[:end], number)
        if text[0] in "{&*!|>%@`" or text in ("-", "?", "=") or text.startswith("? "):
            self.fail(number, f"the node {text!r}")
        if _TIMESTAMP.match(text):
            self.fail(number, f"the date {text!r}")
        return resolve_plain(text)

    def quoted_end(self, text: str, start: int, number: int) -> int:
        """Index just past the quoted scalar that opens at ``start``."""
        quote = text[start]
        i = start + 1
        while i < len(text):
            c = text[i]
            if quote == '"' and c == "\\":
                i += 2
                continue
            if c == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 2
                    continue
                return i + 1
            i += 1
        self.fail(number, "a quoted scalar over several lines")

    def unquote(self, token: str, number: int) -> str:
        body = token[1:-1]
        if token[0] == "'":
            return body.replace("''", "'")
        out, i = [], 0
        while i < len(body):
            c = body[i]
            if c != "\\":
                out.append(c)
                i += 1
                continue
            e = body[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = body[i + 2:i + 2 + n]
                if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                    self.fail(number, f"the escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                self.fail(number, f"the escape \\{e}")
        return "".join(out)

    def flow_list(self, text: str, start: int, number: int) -> tuple[list, int]:
        """The flow list opening at ``text[start] == '['`` and the index
        just past its ``]``."""
        out: list = []
        i = start + 1
        expect_item = True
        while True:
            while i < len(text) and text[i] == " ":
                i += 1
            if i >= len(text):
                self.fail(number, "a flow list over several lines")
            c = text[i]
            if c == "]":
                return out, i + 1
            if c == ",":
                if expect_item:
                    self.fail(number, "an empty flow list entry")
                expect_item = True
                i += 1
                continue
            if not expect_item:
                self.fail(number, "flow list entries without a comma")
            if c == "[":
                value, i = self.flow_list(text, i, number)
            elif c in "'\"":
                end = self.quoted_end(text, i, number)
                value, i = self.unquote(text[i:end], number), end
            elif c in "{&*!|>%@`?":
                self.fail(number, f"the flow node starting {c!r}")
            else:
                m = re.compile(r"[^,\]\[{}]*").match(text, i)
                token = m.group(0).rstrip()
                if ": " in token or token.endswith(":"):
                    self.fail(number, "a map inside a flow list")
                if _TIMESTAMP.match(token):
                    self.fail(number, f"the date {token!r}")
                value, i = resolve_plain(token), m.end()
            out.append(value)
            expect_item = False


def loads_yaml(text: str, source: str = "<string>") -> Any:
    """Parse YAML ``text`` of the subset; ``source`` names it in errors."""
    return _Reader(text, source).document()


def load_yaml(path: str) -> Any:
    """Read a YAML file of the subset: the value ``yaml.safe_load`` gives."""
    with open(path, "r") as fh:
        return loads_yaml(fh.read(), path)


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        text = repr(value)
        if "e" in text and "." not in text.split("e")[0]:
            text = text.replace("e", ".0e", 1)   # PyYAML's 1.0e-05, not the string 1e-05
        return {"inf": ".inf", "-inf": "-.inf", "nan": ".nan"}.get(text, text)
    if isinstance(value, str):
        return json.dumps(value)   # a double-quoted YAML scalar
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_scalar(v) for v in value) + "]"
    raise TypeError(f"no YAML subset form for {type(value).__name__}")


def dumps_yaml(tree: Mapping[str, Any], indent: int = 0) -> str:
    """Write a nested mapping as YAML of the subset :func:`loads_yaml` reads
    (block maps, flow lists, quoted strings), which reads back to the same
    value here and in ``yaml.safe_load``, except an empty map: it is
    written as an empty value (None), which the config loaders read as an
    empty section."""
    lines = []
    for key, value in tree.items():
        if isinstance(value, Mapping) and value:
            lines.append(" " * indent + f"{key}:")
            lines.append(dumps_yaml(value, indent + 2).rstrip("\n"))
        else:
            lines.append(" " * indent + (f"{key}:" if isinstance(value, Mapping)
                                         else f"{key}: {_scalar(value)}"))
    return "\n".join(lines) + "\n"
