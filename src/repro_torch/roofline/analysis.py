"""Roofline terms of one step of the port.  Counterpart of
``repro/roofline/analysis.py``.

Three terms per (arch × shape × mesh), all in seconds:

  compute    = FLOPs_per_device / peak_FLOP/s
  memory     = bytes_per_device / HBM_bw
  collective = collective_bytes_per_device / link_bw

JAX reads the FLOPs and bytes from XLA's ``cost_analysis()`` of the SPMD
module, and the collective bytes from the compiled HLO text.  The port
emits no HLO: its counts come from one rank's program run on the meta
device (``roofline.count``, ``launch.dryrun``), and its collective bytes
from the mesh's own record of the collectives that rank called
(:func:`traffic_bytes` over ``core.mesh``'s ``traffic``).  The HLO text
functions are kept as JAX's, held to its on its own HLO, since they read
what JAX writes.

``Hardware``'s defaults are the NVIDIA H100 SXM data sheet's rates (dense,
no sparsity, at the full 700 W power limit): bf16 on the tensor cores,
HBM3, and one direction of NVLink 4.  ``HW_F32`` holds the f32 rate
outside the tensor cores, for f32 work such as the graph policy.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"\b(f64|f32|f16|bf16|f8e4m3|f8e5m2|s64|u64|s32|u32|"
                       r"s16|u16|s8|u8|pred|c64|c128)\[([0-9,]*)\]")
_COLL_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?\S+\s*=\s*(.+?)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(", )
_GROUP_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUP_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_COMP_HEADER_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*\(.*\)"
                             r"\s*->\s*.*\{\s*$")
_WHILE_RE = re.compile(r"while\(.*?condition=%?([\w\.\-]+),\s*"
                       r"body=%?([\w\.\-]+)", re.S)
_CONST_RE = re.compile(r"\b[su]32\[\]\s+constant\((\d+)\)")

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One NVIDIA H100 SXM, from its data sheet (dense rates, 700 W)."""
    peak_flops: float = 989.4e12      # bf16 FLOP/s on the tensor cores
    hbm_bw: float = 3.35e12           # HBM3, B/s
    link_bw: float = 450e9            # NVLink 4, B/s in one direction


HW = Hardware()
HW_F32 = Hardware(peak_flops=66.9e12)   # f32 outside the tensor cores


def _shape_bytes(type_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.groups()
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str) -> int:
    m = _GROUP_RE.search(line)
    if m:
        return int(m.group(2))            # [num_groups, group_size]
    m = _GROUP_LIST_RE.search(line)
    if m:
        return len([x for x in m.group(1).split(",") if x.strip() != ""])
    return 1


def _moved(kind: str, s: float, g: int) -> float:
    """Bytes a device moves over its links in a ring collective of kind
    ``kind`` over ``g`` devices whose local result is ``s`` bytes (the
    formulas of :func:`collective_bytes`)."""
    if kind == "all-reduce":
        return 2.0 * s * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return s * (g - 1) / g
    if kind == "reduce-scatter":
        return s * (g - 1)
    return float(s)


def _line_bytes(line: str):
    """(kind, moved_bytes) for a collective instruction line, else None."""
    m = _COLL_RE.match(line)
    if m is None or "-done(" in line:
        return None                        # async pair: count -start only
    type_str, kind = m.groups()
    g = _group_size(line)
    if g <= 1:
        return None
    return kind, _moved(kind, _shape_bytes(type_str), g)


def _split_computations(hlo_text: str) -> Dict[str, list]:
    comps: Dict[str, list] = {}
    name, buf = None, []
    for line in hlo_text.splitlines():
        if name is None:
            m = _COMP_HEADER_RE.match(line.strip())
            if m and line.rstrip().endswith("{"):
                name = m.group(1)
                buf = []
        else:
            if line.strip() == "}":
                comps[name] = buf
                name = None
            else:
                buf.append(line)
    return comps


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-device bytes moved over links, by collective kind (ring model),
    from JAX's compiled HLO text:

      all-reduce      2·S·(g-1)/g     (S = local result bytes)
      all-gather      S·(g-1)/g       (S = gathered local result)
      reduce-scatter  S·(g-1)         (S = local shard result)
      all-to-all      S·(g-1)/g
      collective-permute  S

    Collectives inside ``while`` bodies (lax.scan) are multiplied by the trip
    count parsed from the loop-condition constant — XLA's own cost analysis
    counts loop bodies once, which would understate scan-heavy models.
    """
    comps = _split_computations(hlo_text)

    def trip_count(cond_name: str) -> int:
        lines = comps.get(cond_name, [])
        consts = [int(m.group(1)) for l in lines
                  for m in _CONST_RE.finditer(l)]
        return max(consts) if consts else 1

    memo: Dict[str, Dict[str, float]] = {}

    def walk(name: str) -> Dict[str, float]:
        if name in memo:
            return memo[name]
        acc = {k: 0.0 for k in KINDS}
        acc["count"] = 0.0
        memo[name] = acc                   # guards cycles
        for line in comps.get(name, []):
            lb = _line_bytes(line)
            if lb is not None:
                acc[lb[0]] += lb[1]
                acc["count"] += 1
            wm = _WHILE_RE.search(line)
            if wm:
                cond, body = wm.groups()
                trips = trip_count(cond)
                sub = walk(body)
                for k in KINDS:
                    acc[k] += trips * sub[k]
                acc["count"] += trips * sub["count"]
            elif "calls=" in line:
                cm = re.search(r"calls=%?([\w\.\-]+)", line)
                if cm and cm.group(1) in comps:
                    sub = walk(cm.group(1))
                    for k in KINDS:
                        acc[k] += sub[k]
                    acc["count"] += sub["count"]
        return acc

    # the entry: the computation named main (or *.main), else the last one
    entry = None
    for cand in comps:
        if cand.startswith("main") or cand.endswith(".main"):
            entry = cand
    if entry is None and comps:
        entry = list(comps)[-1]
    out = walk(entry) if entry else {k: 0.0 for k in KINDS + ("count",)}
    out = dict(out)
    out["total"] = sum(out[k] for k in KINDS)
    return out


# the port's collectives (``core.mesh``'s ``traffic`` keys, "<name> <axis>"
# with an optional " backward") by JAX's kind; the mesh records the rank's
# OPERAND bytes s, JAX's formulas take the local RESULT S
TRAFFIC_KINDS = {
    "all_reduce": "all-reduce",          # S = s
    "all_reduce_max": "all-reduce",      # S = s
    "grad_all_reduce": "all-reduce",     # S = s
    "all_gather": "all-gather",          # S = s·g: moves s·(g-1)
    "all_to_all": "all-to-all",          # S = s
    "grad_broadcast": "collective-permute",  # a chain: each device takes s
    "broadcast": "collective-permute",
}


def traffic_bytes(traffic: dict, mesh) -> Dict[str, float]:
    """The port's counterpart of :func:`collective_bytes`: per-device bytes
    moved over links by kind, ``count`` and ``total``, from a mesh's
    ``traffic`` record (``{"<name> <axis>[ backward]": [calls, operand
    bytes]}``, ``core.mesh``).  Each key takes JAX's ring formula of its
    kind (``TRAFFIC_KINDS``) with g the size of its axis (``world``: every
    rank of the mesh), its operand s converted to JAX's local result S:

      all_reduce, all_reduce_max, grad_all_reduce  2·s·(g-1)/g
      all_gather                                   s·(g-1)      (S = s·g)
      all_to_all                                   s·(g-1)/g
      grad_broadcast, broadcast                    s

    The record sums the operands of all calls of a key, and each formula is
    linear in s, so the sum gives the calls' total."""
    out = {k: 0.0 for k in KINDS}
    out["count"] = 0.0
    for key, (calls, nbytes) in traffic.items():
        name, axis = key.split()[:2]
        kind = TRAFFIC_KINDS[name]
        g = mesh.size if axis == "world" else mesh.axis(axis).size
        if g <= 1:
            continue
        s = nbytes * g if name == "all_gather" else nbytes
        out[kind] += _moved(kind, s, g)
        out["count"] += calls
    out["total"] = sum(out[k] for k in KINDS)
    return out


def model_flops(cfg, shape_cfg, active_params: int) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference), D = processed
    tokens; MoE uses active parameters."""
    if shape_cfg.mode == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 6.0 * active_params * tokens
    if shape_cfg.mode == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 2.0 * active_params * tokens
    tokens = shape_cfg.global_batch       # one new token per sequence
    return 2.0 * active_params * tokens


def active_param_count(cfg, params_shape) -> int:
    """Parameter count with MoE expert tensors scaled by k/E (+ shared),
    over a parameter tree of (shape, dtype) leaves or tensors
    (``models.param_shapes``)."""
    from ..sharding.rules import leaf_shape, map_with_path
    total = 0
    frac = (cfg.experts_per_token / cfg.n_experts) if cfg.is_moe else 1.0

    def visit(path, leaf):
        nonlocal total
        shape, _ = leaf_shape(leaf)
        n = 1
        for s in shape:
            n *= s
        if cfg.is_moe and path[-1] in ("ewg", "ewu", "ewo"):
            n = int(n * frac)
        total += n

    map_with_path(visit, params_shape)
    return total


def roofline_terms(cost: dict, coll: Dict[str, float], chips: int,
                   model_fl: float, *, analytic_fl: float = 0.0,
                   analytic_bytes: float = 0.0, hw: Hardware = HW) -> dict:
    """Per-device roofline terms in seconds.

    FLOPs/bytes use max(counted, analytic/chips), JAX's rule: XLA counts a
    while (scan) body once, and the port's count takes only the matmuls'
    FLOPs (``roofline.count``), so the counted numbers can fall short of
    the work; the analytic model (``roofline/analytic.py``) is the floor.
    ``cost`` holds the counted ``flops`` and ``bytes accessed`` of one
    device (the keys of XLA's ``cost_analysis()``, which the ``hlo_*``
    keys of the result keep JAX's names for); the collective bytes come
    from the collectives' record, loops included.
    """
    hlo_flops_dev = float(cost.get("flops", 0.0))
    hlo_bytes_dev = float(cost.get("bytes accessed", 0.0))
    flops_dev = max(hlo_flops_dev, analytic_fl / chips)
    bytes_dev = max(hlo_bytes_dev, analytic_bytes / chips)
    t_compute = flops_dev / hw.peak_flops
    t_memory = bytes_dev / hw.hbm_bw
    t_coll = coll["total"] / hw.link_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    useful = model_fl / max(flops_dev * chips, 1.0)
    return dict(terms, dominant=dom,
                hlo_flops_per_dev=hlo_flops_dev,
                hlo_bytes_per_dev=hlo_bytes_dev,
                analytic_flops_global=analytic_fl,
                analytic_bytes_global=analytic_bytes,
                flops_per_dev_used=flops_dev,
                bytes_per_dev_used=bytes_dev,
                collective_bytes_per_dev=coll["total"],
                collective_count=coll["count"],
                model_flops=model_fl, useful_flops_ratio=useful,
                step_time_bound_s=max(terms.values()))
