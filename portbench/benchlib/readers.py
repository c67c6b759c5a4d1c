"""Readings shared by the per-layer metric files under ``metrics/``: each
takes the traced run's records and returns a number, or None where the
run had nothing to read (the metric is then left out of the line)."""
from __future__ import annotations

from benchlib import arith


def span_ms_per(records, label, per):
    spans = records.get("spans", {}).get(label)
    if not spans or not per:
        return None
    return sum(b - a for a, b in spans) / 1e6 / per


def data_ms_per_round(records):
    """ms a round in the data layer's ``round_batch``."""
    label = "data: round_batch"
    return span_ms_per(records, label,
                       len(records.get("spans", {}).get(label, ())))


def local_step_ms(records):
    """ms a local step: ``RoundEngine.step`` over the rounds' steps."""
    return span_ms_per(records, "round engine: step",
                       records.get("rounds", 0)
                       * records.get("local_steps", 0))


def layer_roofline_pct(records):
    """The layer launches' bound over their device time in the traced
    sub-window, as a share of 100."""
    tr = records.get("trace") or {}
    launches, kernel_s = tr.get("layer_launches"), tr.get("layer_kernel_s")
    if not launches or not kernel_s:
        return None
    bound = 0.0
    for cell, M, T, B, I, H in launches:
        nbytes, flops = arith.layer_bytes_flops(arith.GATES[cell], T, B, I,
                                                H, M=M)
        bound += arith.bound_s(nbytes, flops)[0]
    return 100.0 * bound / kernel_s


def mfu_pct(records):
    """Model FLOPs of the window over its wall at the fp32 peak."""
    flops, wall = records.get("model_flops"), records.get("window_s")
    if not flops or not wall:
        return None
    return 100.0 * flops / (wall * arith.FP32_FLOPS_PER_S)


def device_idle_pct(records):
    tr = records.get("trace") or {}
    if not tr.get("window_s") or not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def flush_ms(records):
    eng = records.get("engine") or {}
    if not eng.get("flushes"):
        return None
    return 1e3 * eng["busy_s"] / eng["flushes"]


def bucket_fill_pct(records):
    eng = records.get("engine") or {}
    if not eng.get("padded_rows"):
        return None
    return 100.0 * eng["requests"] / eng["padded_rows"]
