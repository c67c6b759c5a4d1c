"""Level-3 flcheck: wire-format and cost auditor for the round; the
counterpart of ``src/repro/analysis/costs.py``.

The paper's scalability pitch is a COST claim (int8-quantized uplinks,
edge -> region -> cloud fan-in), but the simulated costs live in a formula
(``core/latency.py::payload_bytes``).  This module proves the cost model
instead: it runs the level-1 taint pass over the REAL round bodies
(``taint.verify_pipeline``, all four execution paths) and reads, off every
boundary crossing, the payload dtype and the declared wire encoding (the
``declassify(..., wire=...)`` markers of ``core/transforms.py`` and
``core/secure_agg.py``), then derives exact per-client upload bytes:

* ``int<k>+scale``: the quantizer's integer grid, ``ceil(size*k/8)`` bytes
  a leaf plus one fp32 scale (4 bytes) a leaf;
* anything else: raw fp32, 4 bytes a coordinate.  With quantize AND masking
  on, the masker works in the quantizer's integer ring mod 2^k, so masked
  uploads keep ``int<k>+scale``; :func:`check_report` treats a re-widened
  masked upload as the FATAL ``masked_fp32_regression``.

The mesh paths (``flat8``: one ``clients`` axis over 8 ranks; ``hier2x4``:
2 regions x 4) run on 8 gloo ranks spawned for the audit
(``taint.on_ranks``), each rank its block of an 8-client round.

Beside the wire audit, :func:`stage_costs` counts the per-stage FLOPs and
bytes of the production round (markers off) with
``launch/costmodel.py::StepTracker``, on the plain cell route (a ctypes
kernel launch is invisible to the dispatcher, so the kernel route would
count the forward's products on the CPU and not on the card), and
positions them against the H100 constants of ``launch/mesh.py`` (the
roofline's).

**What is and is not proved.**  The audit proves the DECLARED wire format
reaching each boundary on the run dataflow: the quantizer's dequantized
floats stand for the int grid a real uplink ships, and no later stage
re-widened them.  It does not measure a network, model headers or framing,
and the FLOP counts inherit the cost model's fusion-blind byte count.  The
report is deterministic for a fixed torch version (recorded in it, not
compared), which makes the baseline diff a gate:
``tools/flcheck_torch --cost --baseline
src/repro_torch/analysis/baselines/round_costs.json`` fails when wire
bytes, boundary dtypes or stage FLOPs drift without a deliberate
``--update-baseline``.

Import-light (see ``analysis/__init__``): ``repro_torch.core`` and
``repro_torch.launch`` are imported inside functions only.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Tuple

PyTree = Any

VERSION = 1
# repo-relative committed baseline (the CI gate target)
DEFAULT_BASELINE = "src/repro_torch/analysis/baselines/round_costs.json"

# the audited execution paths; flat8 / hier2x4 run on 8 gloo ranks
PATHS = ("vmap", "semi_sync", "flat8", "hier2x4")
MESH_PATHS = ("flat8", "hier2x4")


def _audit_matrix():
    """(name, tcfg, scfg) triples the canonical report covers: raw-fp32,
    quantize-on (the int8 proof target), and quantize+secure (the ring-
    masked path, which must hold the int8 wire UNDER masking)."""
    from repro_torch.configs.base import SecureAggConfig, TransformConfig
    return (
        ("fp32", TransformConfig(clip_norm=1.0), None),
        ("quantize8", TransformConfig(clip_norm=1.0, quantize_bits=8), None),
        ("quantize8_secure",
         TransformConfig(clip_norm=1.0, quantize_bits=8),
         SecureAggConfig(enabled=True)),
    )


# ------------------------------------------------------------ wire formats
def wire_bits(wire: Optional[str]) -> int:
    """Payload bits per coordinate for a declared wire encoding."""
    if wire and wire.startswith("int") and wire.endswith("+scale"):
        return int(wire[3:-len("+scale")])
    return 32


def leaf_wire_bytes(size: int, wire: Optional[str]) -> int:
    """Exact uplink bytes of ONE leaf of ``size`` coordinates: the integer
    grid packed to ``ceil(size*k/8)`` plus its fp32 scale, or raw fp32."""
    if wire and wire.startswith("int") and wire.endswith("+scale"):
        k = wire_bits(wire)
        return math.ceil(size * k / 8) + 4          # +4: per-leaf fp32 scale
    return size * 4


def model_leaf_sizes(fcfg) -> List[int]:
    """Coordinate counts of the model's param leaves, in
    ``sorted_leaves`` order (the reference's ``jax.tree.leaves``)."""
    from repro_torch.models import forecaster
    from repro_torch.models.layers import sorted_leaves

    return [int(t.numel()) for t in
            sorted_leaves(forecaster.param_template(fcfg))]


def payload_bytes_for_wire(fcfg, wire: Optional[str]) -> int:
    """Audited per-client upload bytes: the declared wire encoding applied
    leaf-by-leaf to the model's parameter tree."""
    return sum(leaf_wire_bytes(s, wire) for s in model_leaf_sizes(fcfg))


# ------------------------------------------------------------- path audits
def _verify(topology: str, tcfg, scfg, fcfg, device):
    from repro_torch.analysis import taint
    if topology in MESH_PATHS:
        import torch.distributed as dist
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != taint.MESH_RANKS:
            raise ValueError(f"{topology} runs on {taint.MESH_RANKS} ranks "
                             f"(this process group has {world}); "
                             "cost_report spawns them")
    topo = {"flat8": "flat", "hier2x4": "hier"}.get(topology, topology)
    return taint.verify_pipeline(topo, tcfg, scfg, fcfg=fcfg, device=device)


def audit_round(topology: str, tcfg, scfg=None, fcfg=None,
                device=None) -> Dict[str, Any]:
    """Audit one (execution path, config): taint-proof the boundary, read
    the declared wire encoding off the tainted crossings, and derive the
    exact per-client upload bytes plus the tracked divergences against the
    ``latency.payload_bytes`` formula.  The mesh paths run on this rank of
    an initialised 8-rank group (every rank calls it)."""
    from repro_torch.configs.base import ForecasterConfig
    from repro_torch.core import latency

    fcfg = fcfg or ForecasterConfig(hidden_dim=8)
    report = _verify(topology, tcfg, scfg, fcfg, device)
    bnd = [c for c in report.crossings if c.primitive == "boundary"]
    tainted = [c for c in bnd if c.tainted]
    # all upload leaves must agree on the encoding; a mix joins to widest
    wires = {c.wire for c in tainted}
    wire = None
    for w in wires:
        wire = w if wire is None and w is not None else wire
    if None in wires or not wires:
        wire = "float32"                 # undeclared leaves ship raw fp32
    labels = sorted(set.intersection(*[set(c.labels) for c in tainted])) \
        if tainted else []

    sizes = model_leaf_sizes(fcfg)
    n_params = sum(sizes)
    audited = sum(leaf_wire_bytes(s, wire) for s in sizes)
    # what RoundEngine charges the latency model (formula, not audit): the
    # quantized wire survives masking (ring masks live in the int grid),
    # so masked and clear uploads are charged identically
    modeled = latency.payload_bytes(n_params, tcfg.quantize_bits)

    divergences: List[Dict[str, Any]] = []
    if tcfg.quantize_bits:
        # formula ignores the per-leaf fp32 scale the real wire carries
        delta = audited - latency.payload_bytes(n_params, tcfg.quantize_bits)
        if delta:
            divergences.append(dict(
                kind="scale_overhead", bytes=int(delta), fatal=False,
                note=f"{len(sizes)} per-leaf fp32 scales the "
                     "payload_bytes formula documents as ignored"))

    return {
        "proved": bool(report.proved),
        "wire": wire,
        "labels": labels,
        "upload_bytes_per_client": int(audited),
        "modeled_bytes_per_client": int(modeled),
        "divergences": divergences,
        "crossings": [
            {"primitive": c.primitive, "shape": list(c.shape),
             "dtype": c.dtype, "tainted": bool(c.tainted),
             "wire": (c.wire or "float32") if c.tainted else c.dtype}
            for c in bnd],
    }


def audit_upload(fcfg, tcfg, scfg=None, topology: str = "vmap",
                 device=None) -> Dict[str, Any]:
    """Bench-facing wrapper: audited vs modeled upload bytes for one
    config on one path (default: the local round; the wire format is
    path-invariant, proved by the full matrix in the cost report)."""
    a = audit_round(topology, tcfg, scfg, fcfg, device)
    return {"wire": a["wire"],
            "audited_bytes": a["upload_bytes_per_client"],
            "modeled_bytes": a["modeled_bytes_per_client"],
            "divergences": a["divergences"],
            "proved": a["proved"]}


# ------------------------------------------------------------- stage costs
def _roofline_position(flops: int, hbm_bytes: int) -> Dict[str, Any]:
    from repro_torch.launch import mesh as mesh_mod
    compute_s = flops / mesh_mod.PEAK_FLOPS
    hbm_s = hbm_bytes / mesh_mod.HBM_BW
    return {"compute_s": float(f"{compute_s:.3e}"),
            "hbm_s": float(f"{hbm_s:.3e}"),
            "bound": "memory" if hbm_s > compute_s else "compute"}


def stage_costs(fcfg, tcfg, scfg=None, m: int = 4,
                device=None) -> Dict[str, Any]:
    """Per-stage FLOP / byte totals of the production round (markers off,
    the plain cell route), positioned against the H100 constants of
    ``launch/mesh.py``.

    ``client_dispatch`` is the local-update -> transform prefix (the
    semi-sync dispatch body); ``round_total`` the whole local round; the
    aggregate + server remainder is their difference (both runs share
    shapes and inputs)."""
    from repro_torch.analysis import taint
    from repro_torch.launch.costmodel import StepTracker

    rc = taint.trace_pipeline_round(fcfg, tcfg, scfg, m=m, cell_impl="torch",
                                    device=device, mode=StepTracker())
    dc = taint.trace_client_deltas(fcfg, tcfg, scfg, m=m, cell_impl="torch",
                                   device=device, mode=StepTracker())
    agg_f = max(int(rc.flops) - int(dc.flops), 0)
    agg_b = max(int(rc.bytes) - int(dc.bytes), 0)
    out = {
        "client_dispatch": {"flops": int(dc.flops),
                            "hbm_bytes": int(dc.bytes)},
        "round_total": {"flops": int(rc.flops), "hbm_bytes": int(rc.bytes)},
        "aggregate_server": {"flops": agg_f, "hbm_bytes": agg_b,
                             "derived": True},
    }
    for stage in out.values():
        stage["roofline"] = _roofline_position(stage["flops"],
                                               stage["hbm_bytes"])
    return out


# ---------------------------------------------------------- report + gate
def mesh_audits(fcfg, device=None) -> Dict[str, Any]:
    """This rank's audits of the mesh paths, every config of the matrix;
    every rank of the 8-rank group calls it."""
    return {f"{path}/{cname}": audit_round(path, tcfg, scfg, fcfg, device)
            for path in MESH_PATHS for cname, tcfg, scfg in _audit_matrix()}


def cost_report(fcfg=None, device=None) -> Dict[str, Any]:
    """The canonical cost report the baseline gate diffs: the fixed small
    model, the fixed config matrix on every path (the mesh paths on 8
    spawned gloo ranks, which must agree), the stage costs of the
    quantize-on config.  ``device`` defaults to the card."""
    import torch

    from repro_torch.analysis import taint
    from repro_torch.configs.base import ForecasterConfig

    fcfg = fcfg or ForecasterConfig(hidden_dim=8)
    sizes = model_leaf_sizes(fcfg)
    audits: Dict[str, Any] = {}
    for path in PATHS:
        if path in MESH_PATHS:
            continue
        for cname, tcfg, scfg in _audit_matrix():
            audits[f"{path}/{cname}"] = audit_round(path, tcfg, scfg, fcfg,
                                                    device)
    ranks = taint.on_ranks(mesh_audits, taint.MESH_RANKS, fcfg,
                           None if device is None else str(device))
    if any(r != ranks[0] for r in ranks[1:]):
        raise RuntimeError("the mesh audits differ between ranks")
    audits.update(ranks[0])
    q8 = _audit_matrix()[1]
    return {
        "version": VERSION,
        "made_with": {"torch": torch.__version__.split("+")[0]},
        "model": {"cell": fcfg.cell, "hidden_dim": fcfg.hidden_dim,
                  "lookback": fcfg.lookback, "horizon": fcfg.horizon,
                  "n_params": int(sum(sizes)), "n_leaves": len(sizes)},
        "audits": audits,
        "skipped": {},
        "stages": stage_costs(fcfg, q8[1], q8[2], device=device),
        "stage_trace": "quantize8 config, local round, m=4 clients, "
                       "plain cell route",
    }


def check_report(report: Dict[str, Any]) -> List[str]:
    """The int8 wire PROOF: fatal messages when any audited path breaks the
    declared-format contract (independent of any baseline)."""
    fatal: List[str] = []
    for key, a in sorted(report["audits"].items()):
        path, cname = key.split("/", 1)
        if not a["proved"]:
            fatal.append(f"{key}: taint proof is not non-vacuous — the "
                         "boundary markers are disconnected")
        if cname == "quantize8" and a["wire"] != "int8+scale":
            fatal.append(
                f"{key}: quantize-on upload is {a['wire']!r}, expected "
                "'int8+scale' — a stage after the quantizer re-widened "
                "the wire (or the quantizer lost its declaration)")
        if cname == "quantize8_secure" and a["wire"] != "int8+scale":
            fatal.append(
                f"{key}: masked_fp32_regression — the quantize+mask upload "
                f"is {a['wire']!r}, expected 'int8+scale': the masker "
                "re-widened the ring wire (masks must stay in the "
                "quantizer's integer ring mod 2^b)")
        if cname == "fp32" and wire_bits(a["wire"]) != 32:
            fatal.append(f"{key}: raw config declares {a['wire']!r} — an "
                         "int grid without a quantize stage cannot be real")
    return fatal


def canonical_json(report: Dict[str, Any]) -> str:
    return json.dumps(report, sort_keys=True, indent=2) + "\n"


def diff_reports(baseline: Dict[str, Any], current: Dict[str, Any]
                 ) -> Tuple[List[str], List[str]]:
    """(errors, warnings) between the committed baseline and a fresh
    report.  Errors gate CI: wire bytes, boundary dtypes/shapes, declared
    encodings, and stage FLOP/byte totals must match the baseline exactly;
    a path a report lists under ``skipped`` is a warning, never silent.
    ``made_with`` is not compared."""
    errors: List[str] = []
    warnings: List[str] = []
    if baseline.get("version") != current.get("version"):
        errors.append(f"report version {current.get('version')} != baseline "
                      f"{baseline.get('version')}")
        return errors, warnings
    if baseline.get("model") != current.get("model"):
        errors.append(f"audited model changed: {current.get('model')} != "
                      f"baseline {baseline.get('model')}")
    b_aud, c_aud = baseline.get("audits", {}), current.get("audits", {})
    for key in sorted(set(b_aud) | set(c_aud)):
        if key not in c_aud:
            path = key.split("/", 1)[0]
            if path in current.get("skipped", {}):
                warnings.append(f"{key}: not audited here "
                                f"({current['skipped'][path]}) — baseline "
                                "entry kept, compared in CI")
            else:
                errors.append(f"{key}: in baseline but not audited — "
                              "removed path needs --update-baseline")
            continue
        if key not in b_aud:
            errors.append(f"{key}: audited but absent from baseline — new "
                          "path needs --update-baseline")
            continue
        b, c = b_aud[key], c_aud[key]
        for field in ("wire", "upload_bytes_per_client",
                      "modeled_bytes_per_client", "labels", "proved"):
            if b.get(field) != c.get(field):
                errors.append(f"{key}: {field} {c.get(field)!r} != baseline "
                              f"{b.get(field)!r}")
        if b.get("crossings") != c.get("crossings"):
            errors.append(f"{key}: boundary crossings changed "
                          f"({len(c.get('crossings', []))} vs baseline "
                          f"{len(b.get('crossings', []))} records, or "
                          "shape/dtype/wire drift)")
        bdiv = {d["kind"]: d["bytes"] for d in b.get("divergences", [])}
        cdiv = {d["kind"]: d["bytes"] for d in c.get("divergences", [])}
        if bdiv != cdiv:
            errors.append(f"{key}: tracked divergences {cdiv} != baseline "
                          f"{bdiv}")
    b_st, c_st = baseline.get("stages", {}), current.get("stages", {})
    for name in sorted(set(b_st) | set(c_st)):
        b, c = b_st.get(name, {}), c_st.get(name, {})
        for field in ("flops", "hbm_bytes"):
            if b.get(field) != c.get(field):
                errors.append(f"stage {name}: {field} {c.get(field)} != "
                              f"baseline {b.get(field)}")
    return errors, warnings


def render_summary(report: Dict[str, Any]) -> str:
    """Human-readable audit summary (what ``flcheck --cost`` prints)."""
    lines = []
    m = report["model"]
    lines.append(f"cost audit: {m['cell']} h={m['hidden_dim']} "
                 f"({m['n_params']} params, {m['n_leaves']} leaves)")
    for key, a in sorted(report["audits"].items()):
        lines.append(
            f"  {key}: wire={a['wire']} "
            f"upload={a['upload_bytes_per_client']}B "
            f"modeled={a['modeled_bytes_per_client']}B "
            f"proved={a['proved']}")
        for d in a["divergences"]:
            lines.append(f"    tracked divergence [{d['kind']}] "
                         f"{d['bytes']:+d}B: {d['note']}")
    for path, why in sorted(report.get("skipped", {}).items()):
        lines.append(f"  {path}: SKIPPED ({why})")
    for name, st in sorted(report.get("stages", {}).items()):
        r = st["roofline"]
        lines.append(f"  stage {name}: {st['flops']:.3e} flops, "
                     f"{st['hbm_bytes']:.3e} HBM B -> {r['bound']}-bound "
                     f"at the H100's bf16 peak and HBM rate (compute "
                     f"{r['compute_s']:.2e}s, hbm {r['hbm_s']:.2e}s)")
    return "\n".join(lines)
