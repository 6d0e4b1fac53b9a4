"""YAML config handling (port of ``ptbxl_tpu/config.py:27-88``), without PyYAML.

The reference loads plain YAML dicts with ``yaml.safe_load`` and reads nested
keys with inline ``.get`` defaults (scripts/03:63-74, scripts/04:70-104).
Quirks kept:

* ``model.ecg_multimodal`` falls back to ``model.ecg_demo`` (scripts/04:74);
* ``demo_hidden_dim`` falls back to ``demo_feat_dim`` (scripts/04:143-145);
* ``data.base_dir`` is overridden by the ``PTBXL_BASE_DIR`` environment
  variable (the checked-in configs hold a placeholder path);
* declared-but-dormant keys (``train.amp``, ``log.tb``, ``metrics.thresholds:
  search_per_class``) are read and ignored.

The GPU machine has no PyYAML, so ``parse_yaml`` reads the subset the repo's
configs use: block mappings by indentation, flow lists of scalars, plain /
single- / double-quoted scalars, comments.  Scalars are
typed as ``yaml.safe_load`` types them (YAML 1.1 resolvers): ``1.5e-3`` is a
float but ``1e-4`` (no dot) and ``1.0e4`` (no exponent sign) stay strings,
which ``get_float`` coerces as the JAX code does; ``yes``/``on`` are booleans.
Anything else (block sequences, flow mappings, anchors, multi-line scalars)
raises.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_CLASSES = ["MI", "STTC", "HYP", "CD", "NORM"]

# PyYAML's implicit resolvers (yaml/resolver.py, YAML 1.1)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")


def _sexagesimal(body: str, conv) -> Any:
    total = 0
    for part in body.split(":"):
        total = total * 60 + conv(part)
    return total


def _plain_scalar(s: str) -> Any:
    """Type a plain scalar as PyYAML's SafeConstructor does."""
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v.startswith("0"):
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        if v.endswith(".inf"):
            return float("-inf") if v[0] == "-" else float("inf")
        if v.endswith(".nan"):
            return float("nan")
        if ":" in v:
            sign = -1.0 if v[0] == "-" else 1.0
            return sign * _sexagesimal(v.lstrip("+-"), float)
        return float(v)
    return s


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at s[i]; returns (value, index after it)."""
    q = s[i]
    out = []
    j = i + 1
    escapes = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0", "r": "\r"}
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if j + 1 < len(s) and s[j + 1] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\" and j + 1 < len(s):
            if s[j + 1] not in escapes:
                raise ValueError(f"unsupported escape \\{s[j + 1]} in {s!r}")
            out.append(escapes[s[j + 1]])
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted scalar: {s!r}")


def _strip_comment(s: str) -> str:
    """Drop a trailing comment: ``#`` at the start or after whitespace, outside quotes."""
    i, quote = 0, None
    while i < len(s):
        c = s[i]
        if quote:
            if quote == '"' and c == "\\":
                i += 2
                continue
            if c == quote:
                if quote == "'" and i + 1 < len(s) and s[i + 1] == "'":
                    i += 2
                    continue
                quote = None
        elif c in "'\"" and (i == 0 or s[i - 1] in " \t[,:"):
            quote = c
        elif c == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i].rstrip()
        i += 1
    return s.rstrip()


def _scalar(s: str) -> Any:
    s = s.strip()
    if s[:1] in ("'", '"'):
        v, end = _quoted(s, 0)
        if s[end:].strip():
            raise ValueError(f"text after a quoted scalar: {s!r}")
        return v
    if s[:1] == "[":
        return _flow_list(s)
    if s[:1] in ("{", "&", "*", "!", "|", ">"):
        raise ValueError(f"unsupported YAML construct: {s!r}")
    return _plain_scalar(s)


def _flow_list(s: str) -> List[Any]:
    """``[a, "b", 1.5e-3]`` of scalars (no nesting)."""
    if not s.endswith("]"):
        raise ValueError(f"unsupported flow sequence: {s!r}")
    items, i, body = [], 0, s[1:-1]
    while i < len(body):
        while i < len(body) and body[i] in " \t":
            i += 1
        if i >= len(body):
            break
        if body[i] in "'\"":
            v, i = _quoted(body, i)
            items.append(v)
            while i < len(body) and body[i] in " \t":
                i += 1
        else:
            j = body.find(",", i)
            j = len(body) if j < 0 else j
            tok = body[i:j].strip()
            if tok[:1] in ("[", "{"):
                raise ValueError(f"nested flow collections are not supported: {s!r}")
            items.append(_plain_scalar(tok))
            i = j
        if i < len(body):
            if body[i] != ",":
                raise ValueError(f"malformed flow sequence: {s!r}")
            i += 1
    return items


def _split_key(text: str) -> Optional[Tuple[str, str]]:
    """``key: value`` -> (key, value) at the first ': ' or a trailing ':'."""
    if text[:1] in ("'", '"'):
        key, end = _quoted(text, 0)
        rest = text[end:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return key, rest[1:].strip()
        return None
    m = re.search(r":(?:[ \t]|$)", text)
    if m is None:
        return None
    return text[:m.start()].strip(), text[m.end():].strip()


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in indentation are not YAML")
        body = _strip_comment(raw)
        if body.strip() in ("", "---", "..."):
            continue
        lines.append((len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"unexpected indentation at: {lines[end][1]!r}")
    return value


def _block(lines, i: int, indent: int) -> Tuple[Dict[Any, Any], int]:
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        text = lines[i][1]
        if text.startswith("- ") or text == "-":
            raise ValueError(f"block sequences are not supported: {text!r}")
        kv = _split_key(text)
        if kv is None:
            raise ValueError(f"expected 'key: value', got {text!r}")
        key, rest = kv
        key = _plain_scalar(key) if text[:1] not in ("'", '"') else key
        i += 1
        if rest:
            out[key] = _scalar(rest)
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def load_config(path: str) -> Dict[str, Any]:
    """Load a YAML config file into a plain dict (reference: scripts/06:22-24)."""
    with open(path, "r", encoding="utf-8") as f:
        cfg = parse_yaml(f.read())
    if not isinstance(cfg, dict):
        raise ValueError(f"Config at {path} did not parse to a mapping: {type(cfg)}")
    return cfg


def get_seed(cfg: Dict[str, Any]) -> int:
    return int(cfg.get("seed", 42))


def get_classes(cfg: Dict[str, Any]) -> List[str]:
    """Class list with the reference default (reference: scripts/03:76)."""
    return list((cfg.get("data") or {}).get("labels", DEFAULT_CLASSES))


def get_base_dir(cfg: Dict[str, Any]) -> str:
    """data.base_dir, overridable via the PTBXL_BASE_DIR environment variable."""
    env = os.environ.get("PTBXL_BASE_DIR")
    if env:
        return env
    return cfg["data"]["base_dir"]


def get_normalize(cfg: Dict[str, Any]) -> str:
    return (cfg.get("data") or {}).get("normalize", "per_lead")


def model_cfg_ecg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """model.ecg section (reference: scripts/03:71)."""
    return ((cfg.get("model") or {}).get("ecg") or {})


def model_cfg_multimodal(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """model.ecg_multimodal with ecg_demo fallback (reference: scripts/04:74)."""
    model_all = cfg.get("model", {}) or {}
    return model_all.get("ecg_multimodal", model_all.get("ecg_demo", {})) or {}


def multimodal_hidden_dim(model_cfg: Dict[str, Any], default: int = 64) -> int:
    """demo_hidden_dim with demo_feat_dim fallback (reference: scripts/04:143-145)."""
    return int(model_cfg.get("demo_hidden_dim", model_cfg.get("demo_feat_dim", default)))


def train_cfg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    return cfg.get("train", {}) or {}


def log_cfg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    return cfg.get("log", {}) or {}


def get_float(section: Dict[str, Any], key: str, default: float) -> float:
    """YAML scalars like '1e-3' parse as strings; coerce like the reference's
    ``float(train_cfg.get("lr", 1e-3))`` (reference: scripts/03:131)."""
    return float(section.get(key, default))


def get_int(section: Dict[str, Any], key: str, default: int) -> int:
    return int(section.get(key, default))
