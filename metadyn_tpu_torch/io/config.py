"""Run-config reader: JSON, or the YAML subset that ``examples/*.yaml`` use.

The port runs where PyYAML may be missing, so it reads its configs itself.
A text that parses as JSON is JSON.  Otherwise the reader takes:

- block mappings (``key: value``, ``key:`` with a nested block below);
- block sequences (``- item``), of scalars, flow collections or mappings
  (``- name: lam`` with the mapping's other keys indented under it);
- flow mappings and sequences, nested (``[[1.0, 0.6], [0.6, 1.0]]``), also
  across lines: an unclosed bracket continues on the next lines;
- ``#`` comments, on their own line or after a value;
- single- and double-quoted strings (no escapes beyond ``\\"``, ``\\\\``
  and ``''``).

Plain scalars resolve as ``yaml.safe_load`` resolves them (YAML 1.1):
null, bool (``true``/``yes``/``on`` and their cases), int (decimal, 0x,
0o-style leading 0, 0b), float (a dot is required, an exponent needs its
sign: ``1e-5`` is a string, as in PyYAML, ``1.0e-5`` a float), else a
string.  Anchors, tags, block scalars (``|``, ``>``), sexagesimal numbers
and dates are outside the subset and raise ``ValueError``.
"""
from __future__ import annotations

import json
import re

_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE",
                          "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE",
                          "off", "Off", "OFF"), False)}
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)"
                  r"|0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# what the subset leaves out: sexagesimal numbers and timestamps
_OUTSIDE = re.compile(r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                      r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*)$")


def load_config(path: str) -> dict:
    """Read a run config from ``path`` (JSON or the YAML subset)."""
    with open(path) as f:
        return loads(f.read())


def loads(text: str):
    """Parse a config text: JSON if it is JSON, else the YAML subset."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    lines = []
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {no}: tab in indentation")
        body = _strip_comment(raw).rstrip()
        if body.strip() in ("", "---"):
            continue
        if body.strip() == "...":
            break
        lines.append((len(body) - len(body.lstrip(" ")), body.strip(), no))
    if not lines:
        return None
    p = _Block(lines)
    out = p.node(lines[0][0])
    if p.i != len(lines):
        raise ValueError(f"line {lines[p.i][2]}: unexpected indentation")
    return out


def _strip_comment(line: str) -> str:
    """The line without its comment: a ``#`` at the start or after
    whitespace, outside quotes."""
    quote = None
    for k, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (k == 0 or line[k - 1] in " \t[{,:"):
            quote = c
        elif c == "#" and (k == 0 or line[k - 1] in " \t"):
            return line[:k]
    return line


def _scalar(tok: str):
    """A plain scalar, resolved as yaml.safe_load does."""
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if tok[:1] in "&*!|>%@`":
        raise ValueError(f"{tok!r}: outside the supported YAML subset")
    if _INT.match(tok):
        v = tok.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if len(v) > 1 and v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(tok):
        v = tok.replace("_", "").lower()
        if v.endswith(("inf", "nan")):
            return float(v.replace(".", ""))
        return float(v)
    if _OUTSIDE.match(tok):
        raise ValueError(f"{tok!r}: outside the supported YAML subset")
    return tok


def _quoted(text: str, k: int) -> tuple:
    """The quoted string starting at text[k]; returns (value, next k)."""
    q = text[k]
    out, k = [], k + 1
    while k < len(text):
        c = text[k]
        if q == "'" and c == "'":
            if text[k + 1:k + 2] == "'":
                out.append("'")
                k += 2
                continue
            return "".join(out), k + 1
        if q == '"' and c == "\\" and text[k + 1:k + 2] in ('"', "\\"):
            out.append(text[k + 1])
            k += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), k + 1
        out.append(c)
        k += 1
    raise ValueError(f"unterminated quote in {text!r}")


def _value(text: str):
    """A value on one line: a flow collection, a quoted or a plain scalar."""
    if text[:1] in "[{":
        v, k = _Flow(text).parse(0)
        if text[k:].strip():
            raise ValueError(f"trailing text after {text[:k]!r}")
        return v
    if text[:1] in "'\"":
        v, k = _quoted(text, 0)
        if text[k:].strip():
            raise ValueError(f"trailing text after {text[:k]!r}")
        return v
    return _scalar(text)


def _split_key(text: str):
    """``key: rest`` → (key, rest); None when the text is no mapping entry
    (a ``:`` must be followed by a space or end the text)."""
    if text[:1] in "'\"":
        key, k = _quoted(text, 0)
        rest = text[k:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    if text[:1] in "[{":
        return None
    m = re.search(r":(?: |$)", text)
    if m is None:
        return None
    return _scalar(text[:m.start()].strip()), text[m.end():].strip()


class _Flow:
    """Recursive descent over one flow collection's text."""

    def __init__(self, text: str):
        self.t = text

    def _ws(self, k: int) -> int:
        while k < len(self.t) and self.t[k] in " \t":
            k += 1
        return k

    def parse(self, k: int):
        k = self._ws(k)
        c = self.t[k:k + 1]
        if c == "[":
            return self._seq(k + 1)
        if c == "{":
            return self._map(k + 1)
        if c in ("'", '"'):
            return _quoted(self.t, k)
        end = k
        while end < len(self.t) and self.t[end] not in ",]}":
            if self.t[end] == ":" and self.t[end + 1:end + 2] in (" ", ",",
                                                                   "]", "}"):
                break
            end += 1
        return _scalar(self.t[k:end].strip()), end

    def _seq(self, k: int):
        out = []
        k = self._ws(k)
        if self.t[k:k + 1] == "]":
            return out, k + 1
        while True:
            v, k = self.parse(k)
            out.append(v)
            k = self._ws(k)
            c = self.t[k:k + 1]
            if c == "]":
                return out, k + 1
            if c != ",":
                raise ValueError(f"expected , or ] in {self.t!r}")
            k += 1

    def _map(self, k: int):
        out = {}
        k = self._ws(k)
        if self.t[k:k + 1] == "}":
            return out, k + 1
        while True:
            key, k = self.parse(k)
            k = self._ws(k)
            if self.t[k:k + 1] == ":":
                v, k = self.parse(k + 1)
            else:
                v = None
            out[key] = v
            k = self._ws(k)
            c = self.t[k:k + 1]
            if c == "}":
                return out, k + 1
            if c != ",":
                raise ValueError(f"expected , or }} in {self.t!r}")
            k += 1


def _balanced(text: str) -> bool:
    depth, quote = 0, None
    for c in text:
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth <= 0


class _Block:
    """Block structure over (indent, text, line number) rows."""

    def __init__(self, lines):
        self.lines = lines
        self.i = 0

    def _flow_text(self, text: str) -> str:
        """``text`` plus the following rows until its brackets close."""
        while not _balanced(text):
            if self.i >= len(self.lines):
                raise ValueError(f"unclosed flow collection: {text!r}")
            text = text + " " + self.lines[self.i][1]
            self.i += 1
        return text

    def node(self, indent: int):
        if self.lines[self.i][1].startswith("- ") \
                or self.lines[self.i][1] == "-":
            return self._seq(indent)
        return self._map(indent)

    def _inline(self, text: str, indent: int):
        """The value after ``key:`` or ``- ``: inline, or a block below."""
        if text == "":
            if self.i < len(self.lines):
                ind, t, _ = self.lines[self.i]
                if ind > indent or (ind == indent and (t.startswith("- ")
                                                       or t == "-")):
                    return self.node(ind)
            return None
        if text[:1] in "[{":
            text = self._flow_text(text)
        if text[:1] in "|>&*!":
            raise ValueError(f"{text!r}: outside the supported YAML subset")
        return _value(text)

    def _map(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            ind, text, no = self.lines[self.i]
            if ind < indent or text.startswith("- ") or text == "-":
                break
            if ind > indent:
                raise ValueError(f"line {no}: unexpected indentation")
            kv = _split_key(text)
            if kv is None:
                raise ValueError(f"line {no}: expected 'key: value'")
            self.i += 1
            key, rest = kv
            if key in out:
                raise ValueError(f"line {no}: duplicate key {key!r}")
            out[key] = self._inline(rest, indent)
        return out

    def _seq(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, text, no = self.lines[self.i]
            if ind != indent or not (text.startswith("- ") or text == "-"):
                if ind > indent:
                    raise ValueError(f"line {no}: unexpected indentation")
                break
            item = text[1:].strip()
            item_indent = ind + len(text) - len(item) if item else ind + 2
            kv = _split_key(item) if item else None
            if kv is not None:
                # a mapping item: its first entry on the dash row, the
                # rest indented to the entry's column
                self.lines[self.i] = (item_indent, item, no)
                out.append(self._map(item_indent))
            else:
                self.i += 1
                out.append(self._inline(item, ind))
        return out
