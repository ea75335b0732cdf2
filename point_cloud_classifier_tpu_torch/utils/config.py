"""YAML config overlay: a base file recursively overlaid by a specific one,
and the resolved config written into each run directory.

Counterpart of ``point_cloud_classifier_tpu/utils/config.py``, without
PyYAML (a machine that runs the port may have none).  :func:`load_yaml` reads
the part of YAML that the files under ``configs/`` and :func:`save_config`'s
output use, typed as ``yaml.safe_load`` types it, and raises
:class:`YamlError` on anything else.  :func:`save_config` writes
``config.yaml`` byte for byte as ``yaml.safe_dump`` does for what configs
hold — nested dicts (keys sorted), lists, strings, ints, floats, bools and
None.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, List, Optional


def merge_dicts(base: Dict[str, Any], specific: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``specific`` into ``base`` (mutates and returns base;
    nested dicts merge key by key, any other value in ``specific`` wins)."""
    for key, value in specific.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, dict):
            merge_dicts(base[key], value)
        else:
            base[key] = value
    return base


def load_config(base_path: str, specific_path: Optional[str] = None) -> Dict[str, Any]:
    """Load ``base_path`` and optionally overlay ``specific_path`` on top.

    An empty or non-dict specific file leaves the base config untouched.
    """
    with open(base_path) as f:
        config = load_yaml(f.read())
    if specific_path:
        with open(specific_path) as f:
            specific = load_yaml(f.read())
        if isinstance(specific, dict) and specific:
            config = merge_dicts(config, specific)
    return config


# -- writing ------------------------------------------------------------------------

# PyYAML's implicit resolvers (YAML 1.1): a plain string matching one would
# read back as another type, so safe_dump quotes it.
_IMPLICIT = re.compile(
    r"""^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF
    |[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)
    |[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
    |~|null|Null|NULL|<<|=
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]
     (?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    re.X,
)
_WIDTH = 80  # safe_dump folds longer strings at their spaces


def _str_scalar(s: str) -> str:
    if not all(" " <= c <= "~" for c in s):
        raise ValueError(f"save_config writes printable ASCII strings only, got {s!r}")
    if " " in s and len(s) > _WIDTH:
        raise ValueError(f"save_config writes no string with spaces over {_WIDTH} chars")
    plain = (
        s != ""
        and not _IMPLICIT.match(s)
        and s[0] not in "#,[]{}&*!|>'\"%@` "
        and not (s[0] in "-?:" and (len(s) == 1 or s[1] == " "))
        and s[-1] not in " :"
        and ": " not in s
        and " #" not in s
    )
    return s if plain else "'" + s.replace("'", "''") + "'"


def _scalar(v) -> str:
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
        text = repr(v).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if isinstance(v, str):
        return _str_scalar(v)
    if v == {} or v == []:
        return "{}" if isinstance(v, dict) else "[]"
    raise TypeError(f"save_config cannot write {type(v).__name__}")


def _block(value, indent: int) -> List[str]:
    """Block-style lines of a non-empty dict (keys sorted) or list; a list
    under a key sits at the key's indent, as safe_dump writes it."""
    pad = " " * indent
    lines = []
    if isinstance(value, dict):
        for key in sorted(value):
            v = value[key]
            head = f"{pad}{_scalar(key)}:"
            if isinstance(v, (dict, list)) and v:
                lines.append(head)
                lines += _block(v, indent + 2 if isinstance(v, dict) else indent)
            else:
                lines.append(f"{head} {_scalar(v)}")
        return lines
    for v in value:
        if isinstance(v, (dict, list)) and v:
            sub = _block(v, indent + 2)
            lines.append(f"{pad}- {sub[0][indent + 2:]}")
            lines += sub[1:]
        else:
            lines.append(f"{pad}- {_scalar(v)}")
    return lines


def dump_yaml(config: Dict[str, Any]) -> str:
    """``yaml.safe_dump(config)`` for a config dict, without PyYAML."""
    if not config:
        return "{}\n"
    return "\n".join(_block(config, 0)) + "\n"


def save_config(config: Dict[str, Any], log_dir: str) -> str:
    """Write the resolved config as ``{log_dir}/config.yaml``, byte for byte
    as the JAX package's ``save_config`` (``yaml.safe_dump``) does.  Returns
    the written path."""
    os.makedirs(log_dir, exist_ok=True)
    config_path = os.path.join(log_dir, "config.yaml")
    with open(config_path, "w") as f:
        f.write(dump_yaml(config))
    return config_path


# -- reading ------------------------------------------------------------------------


class YamlError(ValueError):
    """The text uses YAML that :func:`load_yaml` does not read."""


_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_INT = re.compile(r"^[-+]?(?:0b[0-1_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$"
)
_SPECIAL_FLOAT = {".inf": math.inf, ".Inf": math.inf, ".INF": math.inf,
                  ".nan": math.nan, ".NaN": math.nan, ".NAN": math.nan}
_ESCAPES = {"0": "\0", "t": "\t", "n": "\n", "r": "\r", '"': '"', "/": "/", "\\": "\\", " ": " "}
# a mapping entry: a quoted or plain key, optional spaces, a colon, then
# nothing or a space and the value
_ENTRY = re.compile(
    r"""^(?P<key>'(?:[^']|'')*'|"(?:[^"\\]|\\.)*"|[^\s'"\[\]{}&*!|>%@`#,?-][^#]*?|-[^\s#][^#]*?)
        \s*:(?:\s+(?P<rest>.*))?$""",
    re.X,
)


def _resolve(text: str):
    """A plain (unquoted) scalar, typed by PyYAML's YAML 1.1 resolvers."""
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        sign = -1 if text[0] == "-" else 1
        digits = text.lstrip("+-").replace("_", "")
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if digits[0] == "0" and len(digits) > 1:
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text.lstrip("+-") in _SPECIAL_FLOAT and (text[0] in "+-." and not text.startswith(("+.n", "-.n"))):
        value = _SPECIAL_FLOAT[text.lstrip("+-")]
        return -value if text[0] == "-" else value
    if _IMPLICIT.match(text):  # a timestamp, a sexagesimal number, a merge key
        raise YamlError(f"load_yaml does not read the scalar {text!r}")
    if text[0] in "!|>%@`{}[]&*" or text.startswith(("? ", "- ")) or text in ("?", "-"):
        raise YamlError(f"load_yaml does not read {text!r}")
    if ": " in text or text.endswith(":"):
        raise YamlError(f"load_yaml does not read a mapping inside {text!r}")
    return text


def _unquote(text: str) -> str:
    """The string of a whole single- or double-quoted scalar."""
    body = text[1:-1]
    if text[0] == "'":
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c == "\\":
            i += 1
            if body[i] not in _ESCAPES:
                raise YamlError(f"load_yaml does not read the escape \\{body[i]}")
            c = _ESCAPES[body[i]]
        out.append(c)
        i += 1
    return "".join(out)


def _quoted_end(text: str, start: int) -> int:
    """The index after the quoted scalar that opens at ``text[start]``."""
    quote, i = text[start], start + 1
    while i < len(text):
        if quote == '"' and text[i] == "\\":
            i += 2
            continue
        if text[i] == quote:
            if quote == "'" and text[i + 1 : i + 2] == "'":
                i += 2
                continue
            return i + 1
        i += 1
    raise YamlError(f"load_yaml found no closing quote in {text!r}")


def _strip_comment(line: str) -> str:
    """``line`` without its comment (a ``#`` at the start or after white
    space, outside quotes) and without trailing white space."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t[,:-"):
            i = _quoted_end(line, i)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


class _Reader:
    def __init__(self, text: str):
        self.lines = []  # (indent, content), comments and blank lines dropped
        self.anchors: Dict[str, Any] = {}
        for raw in text.splitlines():
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise YamlError("load_yaml reads no tab indentation")
            content = _strip_comment(raw)
            if not content.strip():
                continue
            if content.startswith(("---", "...", "%")):
                raise YamlError(f"load_yaml reads one plain document, got {content!r}")
            self.lines.append((len(content) - len(content.lstrip(" ")), content.strip()))
        self.pos = 0

    def document(self):
        if not self.lines:
            return None
        value = self.block(self.lines[0][0])
        if self.pos != len(self.lines):
            raise YamlError(f"load_yaml cannot place the line {self.lines[self.pos][1]!r}")
        return value

    def block(self, indent: int):
        """The mapping or sequence whose lines start at ``indent``."""
        content = self.lines[self.pos][1]
        if content == "-" or content.startswith("- "):
            return self.sequence(indent)
        if not _ENTRY.match(content):
            if self.pos == 0 and len(self.lines) == 1:
                self.pos = 1
                return self.inline(content)
            raise YamlError(f"load_yaml expected 'key: value', got {content!r}")
        return self.mapping(indent)

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.pos < len(self.lines) and self.lines[self.pos][0] == indent:
            content = self.lines[self.pos][1]
            entry = _ENTRY.match(content)
            if entry is None or content.startswith("- "):
                raise YamlError(f"load_yaml expected 'key: value', got {content!r}")
            key = entry["key"]
            key = _unquote(key) if key[0] in "'\"" else _resolve(key)
            if key in out:
                raise YamlError(f"load_yaml found the key {key!r} twice")
            self.pos += 1
            out[key] = self.value(entry["rest"] or "", indent, in_mapping=True)
        if self.pos < len(self.lines) and self.lines[self.pos][0] > indent:
            raise YamlError(f"load_yaml cannot place the line {self.lines[self.pos][1]!r}")
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.pos < len(self.lines) and self.lines[self.pos][0] == indent:
            content = self.lines[self.pos][1]
            if not (content == "-" or content.startswith("- ")):
                break
            rest = content[1:].strip()
            if rest and (rest == "-" or rest.startswith("- ") or _ENTRY.match(rest)):
                # the item is itself a block that opens on this line
                inner = indent + 1 + (len(content[1:]) - len(content[1:].lstrip(" ")))
                self.lines[self.pos] = (inner, rest)
                out.append(self.block(inner))
            else:
                self.pos += 1
                out.append(self.value(rest, indent, in_mapping=False))
        return out

    def value(self, rest: str, indent: int, in_mapping: bool):
        """What follows ``key:`` or ``-``: a scalar on the line, or a nested
        block on the next lines."""
        anchor = None
        if rest.startswith("&"):
            name, _, rest = rest[1:].partition(" ")
            anchor, rest = name, rest.strip()
        if rest:
            result = self.inline(rest)
        elif self.pos < len(self.lines) and self.lines[self.pos][0] > indent:
            result = self.block(self.lines[self.pos][0])
        elif (in_mapping and self.pos < len(self.lines) and self.lines[self.pos][0] == indent
              and (self.lines[self.pos][1] == "-" or self.lines[self.pos][1].startswith("- "))):
            result = self.sequence(indent)  # a list under a key, at the key's indent
        else:
            result = None
        if anchor is not None:
            self.anchors[anchor] = result
        return result

    def inline(self, text: str):
        value, end = self.flow(text, 0, stop="")
        if text[end:].strip():
            raise YamlError(f"load_yaml cannot read {text!r}")
        return value

    def flow(self, text: str, i: int, stop: str):
        """(value, index after it) of the scalar, alias or flow list that
        starts at ``text[i]``; a plain scalar ends at a character of ``stop``."""
        while i < len(text) and text[i] == " ":
            i += 1
        if i == len(text):
            return None, i
        c = text[i]
        if c == "[":
            out, i = [], i + 1
            while True:
                while i < len(text) and text[i] == " ":
                    i += 1
                if i >= len(text):
                    raise YamlError(f"load_yaml reads flow lists on one line only: {text!r}")
                if text[i] == "]":
                    return out, i + 1
                item, i = self.flow(text, i, stop=",]")
                out.append(item)
                while i < len(text) and text[i] == " ":
                    i += 1
                if i < len(text) and text[i] == ",":
                    i += 1
                elif i >= len(text) or text[i] != "]":
                    raise YamlError(f"load_yaml cannot read the flow list {text!r}")
        if c == "{":
            if text[i:].replace(" ", "").startswith("{}"):
                return {}, text.index("}", i) + 1
            raise YamlError(f"load_yaml reads no flow mapping: {text!r}")
        if c in "'\"":
            end = _quoted_end(text, i)
            return _unquote(text[i:end]), end
        end = i
        while end < len(text) and text[end] not in stop:
            end += 1
        token = text[i:end].strip()
        if token.startswith("*"):
            if token[1:] not in self.anchors:
                raise YamlError(f"load_yaml found the alias {token!r} before its anchor")
            return self.anchors[token[1:]], end
        return _resolve(token), end


def load_yaml(text: str):
    """What ``yaml.safe_load(text)`` returns, for the YAML that configs use:
    block mappings and lists, one-line flow lists, ``{}`` and ``[]``, plain
    and quoted scalars typed by the YAML 1.1 rules (``1e-3`` is a string,
    ``1.0e-3`` a float, ``yes`` a bool), comments, and ``&anchor`` /
    ``*alias`` on scalars and lists.  Anything else (documents, tags, block
    scalars, flow mappings, merge keys, timestamps, multi-line scalars)
    raises :class:`YamlError`."""
    return _Reader(text).document()
