"""Two-layer YAML config system (counterpart of the JAX package's
config/loading.py): an environment YAML holding machine paths (results /
scannet / scannet_frames_25k) plus a per-experiment YAML with model /
optimizer / trainer / data_module / visualizer / scenes / cl blocks.

The port reads the YAML with a reader of its own, so that it does not need
PyYAML. The reader takes the subset of YAML that cfg/**/*.yml uses: block
mappings and block sequences (indented or not, items that are scalars or
mappings), plain scalars, single- and double-quoted strings, comments, a
leading `---`. Anything else (flow collections, block scalars, anchors,
aliases, tags, multi-line plain scalars, timestamps, merge keys) raises
YAMLSubsetError naming the file and line. Plain scalars resolve as
PyYAML's FullLoader resolves them (YAML 1.1): `1.0e-5` is a float and
`1e-5` a string (a float needs a dot and a signed exponent); yes / no /
true / false / on / off in their three spellings are bools; `~`, `null` and
an empty value are None; ints may be 0b / 0x / 0-octal / sexagesimal, with
underscores.
"""

import math
import os
import re

_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
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
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YAMLSubsetError(ValueError):
    """A YAML construct outside the subset this reader takes."""


def _sexagesimal(value: str, cast):
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


class _Reader:
    def __init__(self, text: str, source: str):
        self.source = source
        self.lines = []  # (lineno, indent, content) of non-blank lines
        for n, raw in enumerate(text.splitlines(), 1):
            body = raw.rstrip()
            stripped = body.lstrip(" ")
            if stripped.startswith("\t"):
                self.fail(n, "a tab in the indentation")
            if not stripped or stripped.startswith("#"):
                continue
            if not self.lines and stripped.rstrip() == "---":
                continue
            if stripped.startswith(("%", "---", "...")):
                self.fail(n, "directives and further documents")
            self.lines.append((n, len(body) - len(stripped), stripped))

    def fail(self, lineno, what):
        raise YAMLSubsetError(f"{self.source}:{lineno}: {what} is outside "
                              f"the YAML subset this reader takes")

    # ----------------------------------------------------------- scalars
    def quoted(self, lineno, text):
        """A quoted scalar at the start of text → (value, rest of text)."""
        q, out, i = text[0], [], 1
        while i < len(text):
            ch = text[i]
            if ch == q:
                if q == "'" and text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), text[i + 1:]
            if ch == "\\" and q == '"':
                esc = text[i + 1:i + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    i += 2
                    continue
                if esc in _HEX_ESCAPES:
                    width = _HEX_ESCAPES[esc]
                    digits = text[i + 2:i + 2 + width]
                    if len(digits) == width and all(
                            c in "0123456789abcdefABCDEF" for c in digits):
                        out.append(chr(int(digits, 16)))
                        i += 2 + width
                        continue
                self.fail(lineno, f"the escape \\{esc}")
            out.append(ch)
            i += 1
        self.fail(lineno, "a quoted scalar over several lines")

    def plain(self, lineno, text):
        """Resolve a plain scalar as PyYAML's FullLoader does."""
        if text[:1] in ("[", "{"):
            self.fail(lineno, "a flow collection")
        if text[:1] in ("|", ">"):
            self.fail(lineno, "a block scalar")
        if text[:1] in ("&", "*", "!"):
            self.fail(lineno, "an anchor, alias or tag")
        if text[:1] in ("%", "@", "`", "?") or text.startswith("- ") or \
                text == "-":
            self.fail(lineno, f"a plain scalar starting with {text[0]!r}")
        if ": " in text or text.endswith(":"):
            self.fail(lineno, "a mapping inside a plain scalar")
        if _BOOL.match(text):
            return text.lower() in ("yes", "true", "on")
        if _FLOAT.match(text):
            return _float(text)
        if _INT.match(text):
            return _int(text)
        if _NULL.match(text):
            return None
        if _TIMESTAMP.match(text) or text in ("<<", "="):
            self.fail(lineno, f"the scalar {text!r} (timestamp, merge or "
                              f"value key)")
        return text

    def value(self, lineno, text):
        """A scalar and whatever follows it on the line (a comment)."""
        if text[:1] in ("'", '"'):
            value, rest = self.quoted(lineno, text)
            rest = rest.strip()
            if rest and not rest.startswith("#"):
                self.fail(lineno, f"text after a quoted scalar ({rest!r})")
            return value
        return self.plain(lineno, re.split(r"[ \t]#", text, 1)[0].rstrip())

    def split_key(self, lineno, text):
        """'key: value' → (key, value text or ''), or None when the line
        holds no mapping key."""
        if text[:1] in ("'", '"'):
            key, rest = self.quoted(lineno, text)
            rest = rest.lstrip(" ")
            if rest == ":" or rest.startswith((": ", ":\t")):
                rest = rest[1:].strip()
                return key, "" if rest.startswith("#") else rest
            return None
        m = re.search(r":(?:[ \t]|$)", text)
        c = re.search(r"[ \t]#", text)
        if m is None or (c is not None and c.start() < m.start()):
            return None
        rest = text[m.end():].strip()
        return self.plain(lineno, text[:m.start()].rstrip()), \
            "" if rest.startswith("#") else rest

    # ------------------------------------------------------------ blocks
    def block(self, i, indent):
        """The node whose lines start at self.lines[i], at `indent`."""
        lineno, ind, text = self.lines[i]
        if text == "-" or text.startswith("- "):
            return self.sequence(i, ind)
        if self.split_key(lineno, text) is not None:
            return self.mapping(i, ind)
        node = self.value(lineno, text)
        if i + 1 < len(self.lines) and self.lines[i + 1][1] >= indent:
            self.fail(self.lines[i + 1][0], "a plain scalar over several "
                                            "lines")
        return node, i + 1

    def nested(self, i, indent, lineno, seq_at_indent):
        """A key's or an item's value on the lines after it: a deeper
        block, an indentless sequence (for a mapping key), or None."""
        if i < len(self.lines):
            _, ind, text = self.lines[i]
            is_seq = text == "-" or text.startswith("- ")
            if ind > indent or (seq_at_indent and ind == indent and is_seq):
                return self.block(i, ind)
        return None, i

    def mapping(self, i, indent):
        out = {}
        while i < len(self.lines):
            lineno, ind, text = self.lines[i]
            if ind < indent:
                break
            if ind > indent:
                self.fail(lineno, "an indentation that no block opened")
            kv = self.split_key(lineno, text)
            if kv is None:
                self.fail(lineno, "a line that is not a 'key: value' in a "
                                  "mapping")
            key, rest = kv
            if rest:
                out[key] = self.value(lineno, rest)
                i += 1
                if i < len(self.lines) and self.lines[i][1] > indent:
                    self.fail(self.lines[i][0], "a plain scalar over "
                                                "several lines")
            else:
                out[key], i = self.nested(i + 1, indent, lineno, True)
        return out, i

    def sequence(self, i, indent):
        out = []
        while i < len(self.lines):
            lineno, ind, text = self.lines[i]
            if ind < indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    self.fail(lineno, "an indentation that no block "
                                      "opened")
                break
            if ind > indent:
                self.fail(lineno, "an indentation that no block opened")
            rest = text[1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                item, i = self.nested(i + 1, indent, lineno, False)
            else:
                # an item's inline content reads as a block of its own
                # at the column where it starts
                col = ind + len(text) - len(rest)
                self.lines[i] = (lineno, col, rest)
                item, i = self.block(i, col)
            out.append(item)
        return out, i

    def document(self):
        if not self.lines:
            return None
        node, i = self.block(0, self.lines[0][1])
        if i < len(self.lines):
            self.fail(self.lines[i][0], "a line outside the document's "
                                        "top-level block")
        return node


def parse_yaml(text: str, source: str = "<string>"):
    """The document in `text` (the subset in the module docstring) as
    dicts, lists and scalars; YAMLSubsetError names the line of anything
    outside it."""
    return _Reader(text, source).document()


def load_yaml(path: str):
    with open(path) as f:
        return parse_yaml(f.read(), path)


def load_env(root_dir: str, env_name: str | None = None) -> dict:
    """cfg/env/<env_name>.yml under root_dir; env_name defaults to
    $ENV_WORKSTATION_NAME, else "env". An absolute env_name names a file
    <env_name>.yml anywhere."""
    if env_name is None:
        env_name = os.environ.get("ENV_WORKSTATION_NAME", "env")
    return load_yaml(os.path.join(root_dir, "cfg", "env", env_name + ".yml"))


def load_exp_and_env(root_dir: str, exp_rel_path: str,
                     env_name: str | None = None) -> tuple[dict, dict, str,
                                                           str]:
    """Returns (exp, env, exp_cfg_path, env_cfg_path); exp_rel_path is
    relative to root_dir unless absolute."""
    exp_cfg_path = os.path.join(root_dir, exp_rel_path)
    exp = load_yaml(exp_cfg_path)
    if env_name is None:
        env_name = os.environ.get("ENV_WORKSTATION_NAME", "env")
    env_cfg_path = os.path.join(root_dir, "cfg", "env", env_name + ".yml")
    env = load_yaml(env_cfg_path)
    return exp, env, exp_cfg_path, env_cfg_path
