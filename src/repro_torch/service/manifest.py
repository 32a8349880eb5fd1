"""manifest.yml parsing (paper Listing 1).

A dependency-free YAML-subset parser covering the manifest structure the
paper shows: nested mappings by 2-space indentation, ``- item`` lists of
mappings, and scalar values (int/float/bool/quoted/plain strings). JSON
manifests are accepted too.

Copied from ``repro/service/manifest.py`` unchanged apart from import paths:
the port imports nothing of ``repro``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple, Union


def _parse_scalar(s: str) -> Any:
    s = s.strip()
    if not s:
        return None
    if s.startswith('"') and s.endswith('"') and len(s) >= 2:
        return s[1:-1]
    if s.startswith("'") and s.endswith("'") and len(s) >= 2:
        return s[1:-1]
    low = s.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("null", "~"):
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def parse_manifest(text: str) -> Dict[str, Any]:
    text = text.strip()
    if text.startswith("{"):
        return json.loads(text)
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip(" "))
        lines.append((indent, raw.strip()))
    obj, rest = _parse_block(lines, 0, 0)
    return obj


def _parse_block(lines, i, indent) -> Tuple[Union[Dict, List], int]:
    # list block?
    if i < len(lines) and lines[i][1].startswith("- "):
        out_l: List[Any] = []
        while i < len(lines) and lines[i][0] == indent \
                and lines[i][1].startswith("- "):
            ind, s = lines[i]
            item_text = s[2:]
            if ":" in item_text:
                # list of mappings: first key inline, rest indented deeper
                key, _, val = item_text.partition(":")
                item: Dict[str, Any] = {}
                if val.strip():
                    item[key.strip()] = _parse_scalar(val)
                    i += 1
                else:
                    i += 1
                    sub, i = _parse_block(lines, i, _next_indent(
                        lines, i, indent))
                    item[key.strip()] = sub
                # continuation keys at indent+2
                while i < len(lines) and lines[i][0] > indent \
                        and not lines[i][1].startswith("- "):
                    sub_ind = lines[i][0]
                    kv, i = _parse_block(lines, i, sub_ind)
                    if isinstance(kv, dict):
                        item.update(kv)
                out_l.append(item)
            else:
                out_l.append(_parse_scalar(item_text))
                i += 1
        return out_l, i
    # mapping block
    out: Dict[str, Any] = {}
    while i < len(lines):
        ind, s = lines[i]
        if ind < indent:
            break
        if ind > indent or s.startswith("- "):
            break
        key, _, val = s.partition(":")
        key = key.strip()
        if val.strip():
            out[key] = _parse_scalar(val)
            i += 1
        else:
            i += 1
            if i < len(lines) and lines[i][0] > ind:
                sub, i = _parse_block(lines, i, lines[i][0])
                out[key] = sub
            else:
                out[key] = None
    return out, i


def _next_indent(lines, i, default):
    return lines[i][0] if i < len(lines) else default


# execution backends a manifest may select (runtime/backend.py registry;
# kept as a literal here so manifest validation stays dependency-light)
DISTRIBUTIONS = ("software-ps", "pjit")
DEFAULT_DISTRIBUTION = "software-ps"

# software-PS data-plane knobs (core/software_ps.py)
COMPRESSIONS = ("none", "int8")
DEFAULT_COMPRESSION = "none"
DEFAULT_PS_SHARDS = 4

# framework keys that configure the platform, not the plugin
_FRAMEWORK_META_KEYS = ("name", "version", "distribution",
                        "compression", "ps_shards")


def resolve_distribution(m: Dict[str, Any]) -> str:
    """The execution backend a manifest selects. Precedence: top-level
    ``distribution`` (handy for REST/CLI overrides) > ``framework.
    distribution`` > the default (``software-ps``, the paper-faithful
    path). Raises UserError — the job's fault, not the platform's — on
    unknown values."""
    from repro_torch.errors import UserError
    fw = m.get("framework") or {}
    top = m.get("distribution")
    dist = (top
            or (fw.get("distribution") if isinstance(fw, dict) else None)
            or DEFAULT_DISTRIBUTION)
    if dist not in DISTRIBUTIONS:
        key = "distribution" if top else "framework.distribution"
        raise UserError(f"unknown {key} {dist!r}; "
                        f"supported: {list(DISTRIBUTIONS)}")
    return dist


def resolve_framework(m: Dict[str, Any]
                      ) -> Tuple[Any, Dict[str, Any]]:
    """Framework name + plugin config from a manifest. Accepts both the
    mapping form (``framework: {name: ..., <cfg keys>}``) and the scalar
    shorthand (``framework: repro-lm``) — every consumer (service core
    and execution backends) must go through here so the two forms behave
    identically everywhere."""
    fw = m.get("framework") or {}
    if isinstance(fw, dict):
        cfg = {k: v for k, v in fw.items()
               if k not in _FRAMEWORK_META_KEYS}
        return fw.get("name"), cfg
    return fw, {}


def resolve_ps_options(m: Dict[str, Any]) -> Tuple[str, int]:
    """Software-PS data-plane knobs: ``(compression, ps_shards)``.
    Precedence mirrors ``resolve_distribution``: top-level key (REST/CLI
    override path) > ``framework.<key>`` > default. Raises UserError on
    unknown values — the job's fault, not the platform's."""
    from repro_torch.errors import UserError
    fw = m.get("framework") or {}
    if not isinstance(fw, dict):
        fw = {}
    comp = m.get("compression") or fw.get("compression") \
        or DEFAULT_COMPRESSION
    if comp not in COMPRESSIONS:
        raise UserError(f"unknown compression {comp!r}; "
                        f"supported: {list(COMPRESSIONS)}")
    shards = m.get("ps_shards", fw.get("ps_shards", DEFAULT_PS_SHARDS))
    if not isinstance(shards, int) or isinstance(shards, bool) \
            or shards < 1:
        raise UserError(
            f"ps_shards must be a positive integer, got {shards!r}")
    return comp, shards


def validate_manifest(m: Dict[str, Any]) -> List[str]:
    """Schema checks per the paper's manifest contract."""
    errs = []
    for req in ("name", "framework"):
        if req not in m:
            errs.append(f"missing required field {req!r}")
    fw = m.get("framework") or {}
    if isinstance(fw, dict) and "name" not in fw:
        errs.append("framework.name is required")
    from repro_torch.errors import UserError
    try:
        resolve_distribution(m)
    except UserError as e:
        errs.append(str(e))
    try:
        resolve_ps_options(m)
    except UserError as e:
        errs.append(str(e))
    if "learners" in m and (not isinstance(m["learners"], int)
                            or m["learners"] < 1):
        errs.append("learners must be a positive integer")
    ds = m.get("data_stores")
    if ds is not None and not isinstance(ds, list):
        errs.append("data_stores must be a list")
    return errs
