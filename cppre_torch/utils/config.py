"""Config system: the reference's per-script dict + YAML schema (port of
`cppre.utils.config`).

`load_config` reads the flat schema of the UQ configs (`uq/configs/*.yaml`)
without PyYAML: one `key: value` a line, keys may hold spaces, `#` starts a
comment outside quotes, and a value is a quoted string, a flow list
`[a, 'b', 1]`, a flow mapping (`{}` or `{k: v, ...}` of scalars), or a
plain scalar resolved as PyYAML resolves it (int, float with a dot,
bool, null, else a string). Nested blocks and multi-line values are
refused with ValueError naming the line.
"""

from __future__ import annotations

import re

__all__ = ["load_config", "validate_config", "KNOWN_KEYS"]

KNOWN_KEYS = {
    "Case", "Field", "Model", "Epochs", "Batch Size", "Optimizer",
    "Learning Rate", "Scheduler Step", "Scheduler Gamma", "Activation",
    "Normalisation Strategy", "Physics Normalisation", "T_in", "T_out",
    "Step", "Width", "Width_time", "Width_vars", "Modes", "Variables",
    "Noise", "Loss Function", "UQ", "Dist", "Seed", "Runs",
    "n_train", "n_test", "n_cal", "n_pred",
}

# PyYAML's (YAML 1.1) implicit resolvers for the plain scalars this schema uses
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?$")
_BOOL = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}
_NULL = {"", "~", "null", "Null", "NULL"}


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_flow(body: str) -> list:
    """Split a flow collection's body on top-level commas."""
    items, depth, quote, cur = [], 0, None, ""
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(cur)
            cur = ""
            continue
        cur += ch
    if cur.strip():
        items.append(cur)
    return items


def _scalar(text: str):
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] == "'":
        return t[1:-1].replace("''", "'")
    if len(t) >= 2 and t[0] == t[-1] == '"':
        return t[1:-1].encode().decode("unicode_escape")
    if t.startswith("["):
        if not t.endswith("]"):
            raise ValueError(f"unterminated flow list {t!r}")
        return [_scalar(x) for x in _split_flow(t[1:-1])]
    if t.startswith("{"):
        if not t.endswith("}"):
            raise ValueError(f"unterminated flow mapping {t!r}")
        out = {}
        for item in _split_flow(t[1:-1]):
            key, sep, value = item.partition(":")
            if not sep:
                raise ValueError(f"flow mapping item without ':' in {t!r}")
            out[_scalar(key)] = _scalar(value)
        return out
    if t in _NULL:
        return None
    if t.lower() in _BOOL and t in (t.lower(), t.capitalize(), t.upper()):
        return _BOOL[t.lower()]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t) and any(c.isdigit() for c in t):
        return float(t.replace("_", ""))
    return t


def load_config(path: str) -> dict:
    """The flat YAML mapping in `path` as a dict (see the module docstring)."""
    cfg = {}
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = _strip_comment(raw.rstrip("\n")).rstrip()
            if not line.strip() or line.strip() == "---":
                continue
            if line[0] in " \t-":
                raise ValueError(f"{path}:{lineno}: only a flat mapping of one key a line is "
                                 f"read, got {raw.rstrip()!r}")
            key, sep, value = line.partition(": ") if ": " in line else line.partition(":")
            if not sep or (not value.strip() and not line.endswith(":")):
                raise ValueError(f"{path}:{lineno}: expected 'key: value', got {raw.rstrip()!r}")
            try:
                cfg[_scalar(key)] = _scalar(value)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}") from None
    return cfg


def validate_config(cfg: dict, required=("T_in", "T_out", "Step")) -> dict:
    missing = [k for k in required if k not in cfg]
    if missing:
        raise KeyError(f"config missing required keys: {missing}")
    return cfg
