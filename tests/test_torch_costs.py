"""The port's level-3 flcheck cost auditor (``src/repro_torch/analysis/
costs.py``): the counterparts of ``tests/test_costs.py``.  Where the
reference compares with its committed JSON, the port compares with a live
reference run: ``required_labels`` and ``audit_upload`` (wire, audited and
modeled bytes) must equal ``repro.analysis`` for every config of the audit
matrix on every path, to the byte.  The reference's mesh paths need 8 JAX
devices, so they run in a subprocess with 8 virtual CPU devices; the
port's run on 8 gloo ranks that ``cost_report`` spawns.  Then the port's
own gate: the committed baseline, the self-diff, injected drift, the CLI,
and the audited bytes reaching the latency model.
"""
import copy
import itertools
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import costs as jcosts  # noqa: E402
from repro.analysis import taint as jtaint  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import fedavg as jfedavg  # noqa: E402
from repro_torch.analysis import costs, taint  # noqa: E402
from repro_torch.analysis.cli import find_repo_root, main as cli_main  # noqa: E402
from repro_torch.configs.base import (FLConfig, ForecasterConfig,  # noqa: E402
                                      SecureAggConfig, TransformConfig)
from repro_torch.core import fedavg, latency  # noqa: E402

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FCFG = ForecasterConfig(hidden_dim=8)
JFCFG = jbase.ForecasterConfig(hidden_dim=8)
T_Q8 = TransformConfig(clip_norm=1.0, quantize_bits=8)
T_CLIP = TransformConfig(clip_norm=1.0)
SECURE = SecureAggConfig(enabled=True)
MATRIX = [name for name, _, _ in costs._audit_matrix()]


def _jax_cfgs(name):
    """The reference's (tcfg, scfg) of audit-matrix entry ``name``."""
    return {n: (t, s) for n, t, s in jcosts._audit_matrix()}[name]


def _port_cfgs(name):
    return {n: (t, s) for n, t, s in costs._audit_matrix()}[name]


@pytest.fixture(scope="module")
def report():
    return costs.cost_report(FCFG, device=CPU)


@pytest.fixture(scope="module")
def reference_mesh_uploads():
    """The reference's ``audit_upload`` on flat8 / hier2x4 for the audit
    matrix, live, in a process with 8 virtual CPU devices."""
    code = (
        "import json\n"
        "from repro.analysis import costs\n"
        "from repro.configs.base import ForecasterConfig\n"
        "f = ForecasterConfig(hidden_dim=8)\n"
        "out = {}\n"
        "for path in ('flat8', 'hier2x4'):\n"
        "    for name, t, s in costs._audit_matrix():\n"
        "        out[path + '/' + name] = costs.audit_upload(f, t, s, "
        "topology=path)\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ------------------------------------------------ against the live reference
_TCFGS = [dict(clip_norm=c, noise_multiplier=z, quantize_bits=q)
          for c, z, q in itertools.product((0.0, 1.0), (0.0, 0.5), (0, 8))]


@pytest.mark.parametrize("secure", [False, True])
@pytest.mark.parametrize("kw", _TCFGS,
                         ids=[f"clip{k['clip_norm']}-noise"
                              f"{k['noise_multiplier']}-q"
                              f"{k['quantize_bits']}" for k in _TCFGS])
def test_required_labels_equal_reference(kw, secure):
    got = taint.required_labels(TransformConfig(**kw),
                                SecureAggConfig(enabled=secure))
    want = jtaint.required_labels(jbase.TransformConfig(**kw),
                                  jbase.SecureAggConfig(enabled=secure))
    assert got == want


def test_audit_matrix_equals_reference():
    assert MATRIX == [n for n, _, _ in jcosts._audit_matrix()]
    for name in MATRIX:
        (t, s), (jt, js) = _port_cfgs(name), _jax_cfgs(name)
        assert t.quantize_bits == jt.quantize_bits
        assert t.clip_norm == jt.clip_norm
        assert (s is None) == (js is None)


@pytest.mark.parametrize("name", MATRIX)
@pytest.mark.parametrize("path", ["vmap", "semi_sync"])
def test_audit_upload_equals_reference(path, name):
    t, s = _port_cfgs(name)
    got = costs.audit_upload(FCFG, t, s, topology=path, device=CPU)
    want = jcosts.audit_upload(JFCFG, *_jax_cfgs(name), topology=path)
    for key in ("wire", "audited_bytes", "modeled_bytes", "proved"):
        assert got[key] == want[key], (key, got, want)
    assert got["divergences"] == want["divergences"]


@pytest.mark.parametrize("name", MATRIX)
@pytest.mark.parametrize("path", ["flat8", "hier2x4"])
def test_mesh_audit_upload_equals_reference(report, reference_mesh_uploads,
                                            path, name):
    a = report["audits"][f"{path}/{name}"]
    want = reference_mesh_uploads[f"{path}/{name}"]
    assert a["wire"] == want["wire"]
    assert a["upload_bytes_per_client"] == want["audited_bytes"]
    assert a["modeled_bytes_per_client"] == want["modeled_bytes"]
    assert a["proved"] and want["proved"]


def test_model_leaf_sizes_equal_reference():
    sizes = costs.model_leaf_sizes(FCFG)
    assert sizes == jcosts.model_leaf_sizes(JFCFG)
    assert sum(sizes) == FCFG.num_params() and len(sizes) == 5


# ------------------------------------------------------------ wire algebra
def test_leaf_wire_bytes():
    # int8 grid: 1 byte a coordinate + one fp32 scale a leaf
    assert costs.leaf_wire_bytes(32, "int8+scale") == 36
    # sub-byte grids pack: 4-bit -> ceil(33*4/8) + 4
    assert costs.leaf_wire_bytes(33, "int4+scale") == 17 + 4
    assert costs.leaf_wire_bytes(32, "float32") == 128
    assert costs.leaf_wire_bytes(32, None) == 128


# --------------------------------------------------- per-path wire proofs
@pytest.mark.parametrize("path", ["vmap", "semi_sync", "flat8", "hier2x4"])
def test_quantize_wire_proved_on_every_path(report, path):
    a = report["audits"][f"{path}/quantize8"]
    assert a["proved"]
    assert a["wire"] == "int8+scale"
    tainted = [c for c in a["crossings"] if c["tainted"]]
    assert tainted and all(c["wire"] == "int8+scale" for c in tainted)


def test_quantize_audited_bytes_and_scale_divergence():
    a = costs.audit_round("vmap", T_Q8, None, FCFG, device=CPU)
    n, leaves = FCFG.num_params(), 5
    assert a["upload_bytes_per_client"] == n + 4 * leaves
    assert a["modeled_bytes_per_client"] == n           # formula: ceil(n*8/8)
    (d,) = a["divergences"]
    assert d["kind"] == "scale_overhead"
    assert d["bytes"] == 4 * leaves
    assert d["fatal"] is False


def test_masked_upload_proves_int8_wire_end_to_end():
    """Quantize + mask ships the SAME int8+scale wire as quantize alone:
    ring masking adds zero bytes, and no masked_fp32_regression exists."""
    a = costs.audit_round("vmap", T_Q8, SECURE, FCFG, device=CPU)
    clear = costs.audit_round("vmap", T_Q8, None, FCFG, device=CPU)
    assert a["proved"]
    assert a["wire"] == "int8+scale"
    assert a["upload_bytes_per_client"] == clear["upload_bytes_per_client"]
    assert a["modeled_bytes_per_client"] == clear["modeled_bytes_per_client"]
    tainted = [c for c in a["crossings"] if c["tainted"]]
    assert tainted and all(c["wire"] == "int8+scale" for c in tainted)
    assert costs.check_report({"audits": {"vmap/quantize8_secure": a}}) == []


@pytest.mark.parametrize("path", ["flat8", "hier2x4", "semi_sync"])
def test_masked_wire_proved_on_every_path(report, path):
    a = report["audits"][f"{path}/quantize8_secure"]
    assert a["proved"]
    assert a["wire"] == "int8+scale"


def test_rewidened_masker_is_fatal_regression(report):
    broken = dict(report["audits"]["vmap/quantize8_secure"], wire="float32")
    fatal = costs.check_report({"audits": {"vmap/quantize8_secure": broken}})
    assert fatal and "masked_fp32_regression" in fatal[0]


def test_fp32_config_audited_matches_model():
    a = costs.audit_round("vmap", T_CLIP, None, FCFG, device=CPU)
    assert a["wire"] == "float32"
    assert a["upload_bytes_per_client"] == a["modeled_bytes_per_client"]
    assert a["divergences"] == []


def test_check_report_catches_rewidened_quantize(report):
    broken = dict(report["audits"]["vmap/quantize8"], wire="float32")
    fatal = costs.check_report({"audits": {"vmap/quantize8": broken}})
    assert fatal and "re-widened" in fatal[0]


def test_report_passes_its_own_proof(report):
    assert costs.check_report(report) == []
    assert set(report["audits"]) == {f"{p}/{n}" for p in costs.PATHS
                                     for n in MATRIX}


# ------------------------------------------------------------ stage costs
def test_stage_costs_shape(report):
    stages = report["stages"]
    assert set(stages) == {"client_dispatch", "round_total",
                           "aggregate_server"}
    for st in stages.values():
        assert st["flops"] >= 0 and st["hbm_bytes"] >= 0
        assert st["roofline"]["bound"] in ("compute", "memory")
    # the local round strictly contains the dispatch prefix
    assert stages["round_total"]["flops"] >= \
        stages["client_dispatch"]["flops"]


# ---------------------------------------------------------- baseline gate
def test_self_diff_is_empty(report):
    errors, warnings = costs.diff_reports(report, report)
    assert errors == [] and warnings == []


def test_injected_wire_byte_change_fails_diff(report):
    drifted = copy.deepcopy(report)
    key = next(k for k in drifted["audits"] if k.endswith("/quantize8"))
    drifted["audits"][key]["upload_bytes_per_client"] += 1
    errors, _ = costs.diff_reports(report, drifted)
    assert any("upload_bytes_per_client" in e and key in e for e in errors)


def test_injected_dtype_change_fails_diff(report):
    drifted = copy.deepcopy(report)
    key = next(iter(drifted["audits"]))
    drifted["audits"][key]["crossings"][0]["dtype"] = "float64"
    errors, _ = costs.diff_reports(report, drifted)
    assert any("crossings" in e for e in errors)


def test_injected_stage_flop_change_fails_diff(report):
    drifted = copy.deepcopy(report)
    drifted["stages"]["round_total"]["flops"] += 100
    errors, _ = costs.diff_reports(report, drifted)
    assert any("stage round_total" in e and "flops" in e for e in errors)


def test_skipped_path_is_warning_not_error(report):
    """A baseline entry a report lists as skipped downgrades to a warning,
    never a silent pass or a spurious failure."""
    partial = copy.deepcopy(report)
    for key in [k for k in partial["audits"] if k.startswith("flat8/")]:
        del partial["audits"][key]
    partial["skipped"]["flat8"] = "not run here"
    errors, warnings = costs.diff_reports(copy.deepcopy(report), partial)
    assert errors == []
    assert any("flat8/" in w for w in warnings)


def test_committed_baseline_matches_fresh_report(report):
    """The committed JSON is in sync with the code: the gate, as a test.
    Regenerate with  tools/flcheck_torch --cost --update-baseline  when a
    change intentionally moves wire bytes or stage FLOPs."""
    root = find_repo_root(os.path.dirname(__file__))
    path = os.path.join(root, costs.DEFAULT_BASELINE)
    with open(path, "r", encoding="utf-8") as f:
        baseline = json.load(f)
    errors, warnings = costs.diff_reports(baseline, report)
    assert errors == [] and warnings == [], "\n".join(errors)


def test_canonical_json_is_stable(report):
    s = costs.canonical_json(report)
    assert s == costs.canonical_json(json.loads(s))
    assert s.endswith("\n")


def test_cli_cost_baseline_roundtrip(report, tmp_path, capsys, monkeypatch):
    """--update-baseline writes, --baseline passes against it, and a
    corrupted baseline fails with exit 1 (the report itself is the
    module's, so the CLI spawns no ranks here)."""
    monkeypatch.setattr(costs, "cost_report",
                        lambda fcfg=None, device=None: copy.deepcopy(report))
    bl = tmp_path / "round_costs.json"
    assert cli_main(["--no-lint", "--cost", "--update-baseline",
                     "--baseline", str(bl), "--device", CPU]) == 0
    assert bl.exists()
    assert cli_main(["--no-lint", "--cost", "--baseline", str(bl),
                     "--device", CPU]) == 0
    data = json.loads(bl.read_text())
    key = next(k for k in data["audits"] if k.endswith("/quantize8"))
    data["audits"][key]["upload_bytes_per_client"] += 8
    bl.write_text(json.dumps(data))
    capsys.readouterr()
    assert cli_main(["--no-lint", "--cost", "--baseline", str(bl),
                     "--device", CPU]) == 1
    assert "DRIFT" in capsys.readouterr().out


def test_cli_baseline_without_cost_is_usage_error(capsys):
    assert cli_main(["--baseline", "x.json"]) == 2
    assert "--cost" in capsys.readouterr().err


# ------------------------------------------- latency-model audited rewiring
def test_payload_bytes_audited_override():
    assert latency.payload_bytes(1000, 8) == 1000
    assert latency.payload_bytes(1000, 8, audited_bytes=1020) == 1020.0
    assert latency.payload_bytes(1000, 0, audited_bytes=None) == 4000.0


def test_link_budget_audited_up():
    b_model = latency.link_budget(1000, 30, 3, 8)
    b_audit = latency.link_budget(1000, 30, 3, 8, audited_up=1020)
    assert b_audit["region_fanin_bytes"] == 10 * 1020
    assert b_audit["flat_cloud_ingress_bytes"] == 30 * 1020
    # region->cloud partials stay modeled fp32 in both
    assert b_audit["cloud_ingress_bytes"] == b_model["cloud_ingress_bytes"]


def test_round_engine_accepts_audited_payload():
    """``RoundEngine(audited_payload=)`` charges the audited bytes, as the
    reference's engine does with the same number."""
    a = costs.audit_round("vmap", T_Q8, None, FCFG, device=CPU)
    kw = dict(n_clients=4, clients_per_round=2, rounds=1, lr=0.1,
              n_clusters=0, dp_clip=1.0, quantize_bits=8)
    flcfg = FLConfig(**kw)
    eng = fedavg.RoundEngine(FCFG, flcfg, device=CPU,
                             audited_payload=a["upload_bytes_per_client"])
    expect = a["upload_bytes_per_client"] / \
        flcfg.async_config.latency.uplink_bytes_per_s
    assert eng.latency.uplink_s == pytest.approx(expect)
    jeng = jfedavg.RoundEngine(JFCFG, jbase.FLConfig(**kw),
                               audited_payload=a["upload_bytes_per_client"])
    assert eng.latency.uplink_s == jeng.latency.uplink_s
    # without it, the formula: n_params int8 bytes
    plain = fedavg.RoundEngine(FCFG, flcfg, device=CPU)
    assert plain.latency.uplink_s == pytest.approx(
        FCFG.num_params() / flcfg.async_config.latency.uplink_bytes_per_s)
