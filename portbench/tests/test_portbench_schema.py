"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by a name in it."""
import json
import re

import pytest

from benchlib import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return harness.bench_json()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(bench):
    assert set(bench) == KEYS["top"]
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (harness.ROOT / p).is_dir()
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert any(w.startswith(bench["paths"][0] + "/") for w in cmd)
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells (2 + 14 runs each) fits in 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys(bench):
    names = []
    for kind, key in (("config", "configs"), ("workload", "workloads"),
                      ("end_to_end", "end_to_end"),
                      ("per_layer", "per_layer")):
        items = bench[key]
        for it in items:
            extra = {"workloads"} if kind in ("end_to_end",
                                              "per_layer") else set()
            assert KEYS[kind] <= set(it) <= KEYS[kind] | extra, it
            assert NAME.match(it["name"]), it["name"]
            if "unit" in it:
                assert UNIT.match(it["unit"]), it["unit"]
                assert it["better"] in ("lower", "higher")
                assert it["source"] in SOURCES
            for k in ("why", "layer", "source"):
                if k in it and kind != "end_to_end" and kind != "per_layer":
                    assert _line(it[k])
        names.append([it["name"] for it in items])
    for group in names:
        assert len(group) == len(set(group))
    metric_names = names[2] + names[3]
    assert len(metric_names) == len(set(metric_names))


def test_configs_and_cells(bench):
    cfgs = {c["name"]: c for c in bench["configs"]}
    assert 1 <= len(cfgs) <= 24
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(cfgs)
    files = [c["file"] for c in cfgs.values()]
    assert len(files) == len(set(files))
    for c in cfgs.values():
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
        assert harness.load_json(harness.ROOT / c["file"])["name"] == \
            c["name"]
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in cells)
    assert all(w["chips"] in (1, 4) for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert NAME.match(w["traffic"]) and _line(w["why"])


def test_metrics_cover_every_cell(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        for w in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in
                                  harness.end_to_end_for(bench, w)}
        layers.setdefault(m["layer"], []).append(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in bench["workloads"]:
        mine = harness.end_to_end_for(bench, w["name"])
        assert len(mine) >= 2
        assert harness.per_layer_for(bench, w["name"])


def test_files_found_by_name(bench):
    for w in bench["workloads"]:
        cell, config, traffic, limits = harness.cell_files(bench, w["name"])
        assert (harness.BENCH / "drivers" / f"{traffic['kind']}.py").is_file()
        assert hasattr(harness.driver(traffic["kind"]), "run")
        assert (harness.BENCH / "configs" / config["reference"]).is_file()
        assert limits
    for m in bench["per_layer"]:
        assert harness.read_metric(m["name"], {}) is None


def test_file_names_are_names():
    for p in harness.BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(harness.ROOT).as_posix()
        assert PATH.match(rel), rel
