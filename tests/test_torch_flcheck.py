"""flcheck for the port (``src/repro_torch/analysis/``): the counterparts of
``tests/test_flcheck.py``.  The lint rules against the port's good / bad
fixtures (``tests/fixtures/flcheck_torch/``, the reference's cases in torch
idiom), the taint proofs against the REAL round bodies on all four paths
(the mesh paths on 8 gloo ranks spawned through
``tests/_torch_dist_workers.py``) and against deliberately broken
pipelines, and the hot-path guards.  Everything runs on the CPU
(``device="cpu"``); the card runs the same passes in ``chip_smoke.py``
phase 13.

The taint proofs are the privacy regression: they fail if a transform
stage moves past the aggregation boundary on ANY topology, even when every
numeric pin still passes (masks that cancel in the sum wherever they were
applied).
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from _torch_dist_workers import spawn, taint_proofs  # noqa: E402
from repro_torch.analysis import recompile, taint  # noqa: E402
from repro_torch.analysis.cli import (find_repo_root, lint_file,  # noqa: E402
                                      main as cli_main)
from repro_torch.analysis.concurrency import check_source as conc_check  # noqa: E402
from repro_torch.analysis.determinism import check_source as det_check  # noqa: E402
from repro_torch.analysis.dtypes import check_source as dt_check  # noqa: E402
from repro_torch.analysis.prng_lint import check_source as prng_check  # noqa: E402
from repro_torch.analysis.rules import RULES, Suppressions  # noqa: E402
from repro_torch.configs.base import TransformConfig  # noqa: E402
from repro_torch.core import transforms as transforms_mod  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402

CPU = "cpu"
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "flcheck_torch")
# pretend scope paths: FLC004 / FLC005 fire under core/, FLC006-FLC009
# only under serving/ (see rules.py)
CORE_REL = "src/repro_torch/core/fixture.py"
SERVING_REL = "src/repro_torch/serving/fixture.py"
FIXTURE_REL = {"FLC006": SERVING_REL, "FLC007": SERVING_REL,
               "FLC008": SERVING_REL, "FLC009": SERVING_REL}

ALL_CHECKS = (prng_check, det_check, dt_check, conc_check)

FULL_T = taint.full_stack()          # clip 1.0, noise 0.5, 8-bit quantize
SECURE = taint.secure()


def _run_all(source: str, rel: str = CORE_REL):
    return [f for check in ALL_CHECKS for f in check(source, rel)
            if RULES[f.code].in_scope(rel)]


def _fixture(name: str) -> str:
    with open(os.path.join(FIXTURES, name), "r", encoding="utf-8") as f:
        return f.read()


# ------------------------------------------------------------- level-2 lint
@pytest.mark.parametrize("code", ["FLC001", "FLC002", "FLC003", "FLC004",
                                  "FLC005", "FLC006", "FLC007", "FLC008",
                                  "FLC009"])
def test_bad_fixture_triggers_exactly_its_rule(code):
    rel = FIXTURE_REL.get(code, CORE_REL)
    findings = _run_all(_fixture(f"bad_{code.lower()}.py"), rel)
    assert findings, f"bad fixture for {code} produced no findings"
    assert {f.code for f in findings} == {code}, (
        f"bad fixture for {code} leaked other codes: "
        f"{[(f.code, f.line, f.message) for f in findings]}")
    assert not any(f.suppressed for f in findings)


def test_bad_fixtures_flag_every_marked_line():
    """Each line a bad fixture marks with its code is a finding: the
    torch idioms (manual_seed, seeded_generator, randperm, normal_,
    .double(), .char()) are all caught, not just one of them."""
    for code in ("FLC001", "FLC003", "FLC004", "FLC005", "FLC009"):
        src = _fixture(f"bad_{code.lower()}.py")
        marked = {i for i, line in enumerate(src.splitlines(), start=1)
                  if f"# {code}" in line}
        got = {f.line for f in _run_all(src, FIXTURE_REL.get(code,
                                                             CORE_REL))}
        assert marked and marked == got, (code, sorted(marked), sorted(got))


def test_good_fixture_is_clean():
    findings = _run_all(_fixture("good_clean.py"))
    assert findings == [], [(f.code, f.line, f.message) for f in findings]


def test_good_serving_fixture_is_clean():
    findings = _run_all(_fixture("good_serving.py"), SERVING_REL)
    assert findings == [], [(f.code, f.line, f.message) for f in findings]


def test_scoped_rules_do_not_fire_outside_scope():
    # FLC004 / FLC005 are clean when the file lives in launch/, and the
    # serving-concurrency fixtures are clean outside serving/
    rel = "src/repro_torch/launch/fixture.py"
    for name in ("bad_flc004.py", "bad_flc005.py", "bad_flc006.py",
                 "bad_flc007.py", "bad_flc008.py", "bad_flc009.py"):
        findings = _run_all(_fixture(name), rel)
        assert findings == [], (name, [(f.code, f.line) for f in findings])


def test_suppression_with_rationale_suppresses():
    src = ("from repro_torch.core import prng\n"
           "k = prng.PRNGKey(0)  "
           "# flcheck: disable=FLC001 (test fixture)\n")
    (f,) = prng_check(src, CORE_REL)
    assert f.suppressed and f.suppress_reason == "test fixture"


def test_suppression_without_rationale_is_fatal():
    src = ("import torch\n"
           "torch.manual_seed(0)  # flcheck: disable=FLC001\n")
    (f,) = prng_check(src, CORE_REL)
    assert not f.suppressed            # no rationale -> not suppressed
    assert Suppressions(src).missing_reason == [2]


def test_suppression_on_line_above():
    src = ("from repro_torch.core import prng\n"
           "# flcheck: disable=FLC001 (covers next line)\n"
           "k = prng.PRNGKey(0)\n")
    (f,) = prng_check(src, CORE_REL)
    assert f.suppressed


def test_key_reuse_not_flagged_for_split_rebind():
    src = ("from repro_torch.core import prng\n"
           "def f(key):\n"
           "    key, sub = prng.split(key)\n"
           "    a = prng.normal(sub, (2,))\n"
           "    key, sub = prng.split(key)\n"
           "    b = prng.normal(sub, (2,))\n"
           "    return a + b\n")
    assert prng_check(src, CORE_REL) == []


def test_port_src_tree_is_flcheck_clean():
    """The port's tree has zero unsuppressed findings and every suppression
    carries a rationale: the lint gate, as a test."""
    root = find_repo_root(os.path.dirname(__file__))
    src_dir = os.path.join(root, "src", "repro_torch")
    bad, suppressed = [], 0
    for dirpath, _, filenames in os.walk(src_dir):
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            findings, errors = lint_file(os.path.join(dirpath, fn), root)
            bad.extend(errors)
            bad.extend(f.render() for f in findings if not f.suppressed)
            suppressed += sum(f.suppressed for f in findings)
    assert bad == [], "\n".join(bad)
    assert suppressed == 5      # each named, with its reason, in CHANGES


def test_cli_exit_codes(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert cli_main([str(clean)]) == 0
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import torch\ntorch.manual_seed(7)\n")
    assert cli_main([str(dirty)]) == 1
    assert "FLC001" in capsys.readouterr().out


def test_cli_missing_path_is_fatal(tmp_path, capsys):
    """A typo'd lint target exits 2 with a clear message, never passes as
    'clean'."""
    assert cli_main([str(tmp_path / "no_such_dir")]) == 2
    assert "does not exist" in capsys.readouterr().err


def test_cli_empty_dir_is_fatal(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli_main([str(empty)]) == 2
    assert "no Python files" in capsys.readouterr().err


def test_cli_non_python_file_is_fatal(tmp_path, capsys):
    txt = tmp_path / "notes.txt"
    txt.write_text("hello\n")
    assert cli_main([str(txt)]) == 2
    assert "not a Python file" in capsys.readouterr().err


def test_cli_list_rules_covers_catalog(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for code in RULES:
        assert code in out


def test_cli_dynamic_passes_on_the_cpu(capsys):
    """``--device cpu`` runs the in-process taint proofs and the hot-path
    guards on the CPU, exit 0."""
    assert cli_main(["--no-lint", "--quick-taint", "--hot-path",
                     "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert out.count("flcheck taint OK") == 3
    assert "recompile guard OK" in out and "host-read guard OK" in out


def test_dynamic_passes_default_to_the_card(monkeypatch):
    """Without ``--device`` the dynamic passes run on the card, and
    without a card they fail: no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        taint.verify_pipeline("vmap", FULL_T, SECURE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recompile.check_round_hot_path()


# --------------------------------------------------------- level-1: taint
def test_taint_proves_vmap_full_stack():
    rep = taint.verify_pipeline("vmap", FULL_T, SECURE, device=CPU)
    assert rep.proved, rep.render()
    assert rep.required == frozenset({"clip", "noise", "quantize", "mask"})
    assert rep.checked > 0 and rep.sources > 0    # non-vacuous
    assert rep.launches_after_source == 0


def test_taint_proves_semi_sync_dispatch_path():
    """The dispatch stage's uploads, then their move into the server's
    host buffer: the buffer lies after the boundary and stays clean."""
    rep = taint.verify_pipeline("semi_sync", FULL_T, SECURE, device=CPU)
    assert rep.proved, rep.render()


def test_taint_proves_clip_only_config():
    rep = taint.verify_pipeline("vmap", taint.clip_only(), device=CPU)
    assert rep.proved, rep.render()
    assert rep.required == frozenset({"clip"})


@pytest.fixture(scope="module")
def mesh_reports(tmp_path_factory):
    """Each rank's reports of 8 gloo ranks: [flat full stack, flat
    clip-only, hierarchical 2 x 4 full stack, reduce-before-clip]."""
    d = tmp_path_factory.mktemp("taint_ranks")
    spawn(taint_proofs, taint.MESH_RANKS, d, CPU, timeout_s=240.0)
    out = []
    for r in range(taint.MESH_RANKS):
        with open(os.path.join(str(d), f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("case,label", [(0, "flat full"),
                                        (1, "flat clip-only")])
def test_taint_proves_flat_topology(mesh_reports, case, label):
    for r, reps in enumerate(mesh_reports):
        rep = reps[case]
        assert rep.proved, (label, r, rep.render())
        # every tainted leaf crossed the boundary and the all_reduce
        prims = {c.primitive for c in rep.crossings if c.tainted}
        assert prims == {"boundary", "c10d.allreduce_"}, prims


def test_taint_proves_hierarchical_topology(mesh_reports):
    for r, reps in enumerate(mesh_reports):
        rep = reps[2]
        assert rep.proved, (r, rep.render())
        # hierarchical = the boundary, then two chained all_reduces (edge
        # -> region -> cloud); all three were checked for every leaf
        tainted = [c for c in rep.crossings if c.tainted]
        assert len(tainted) == 3 * rep.sources
        assert rep.checked >= 2


def test_taint_rejects_mask_after_reduce(mesh_reports):
    """The regression the pass exists for: a pipeline that aggregates
    FIRST and sanitizes after is rejected at the raw collective."""
    for reps in mesh_reports:
        rep = reps[3]
        assert not rep.ok
        assert any(v.primitive == "c10d.allreduce_" and "clip" in v.missing
                   for v in rep.violations), rep.render()


def test_taint_rejects_missing_stage_label():
    """A pipeline that clips but skips noising fails a clip+noise policy."""
    stack = transforms_mod.make_stack(TransformConfig(clip_norm=1.0), None)

    def partial_pipeline(deltas, keys):
        deltas = taint.tag_private(deltas)
        deltas = stack(deltas, keys)                 # clip only
        return taint.boundary(deltas["w"].sum(0))

    keys = torch.zeros((4, 2), dtype=torch.int64)
    rep = taint.analyze(partial_pipeline, frozenset({"clip", "noise"}),
                        {"w": torch.ones((4, 3))}, keys)
    assert not rep.ok
    assert all(v.missing == frozenset({"noise"}) for v in rep.violations)


def test_taint_label_meet_on_mixing():
    """Mixing a sanitized value with an unsanitized one weakens the labels
    to the intersection: the mix does NOT count as sanitized."""
    def mix(x):
        priv = taint.tag_private(x)
        cleaned = taint.declassify(priv * 2.0, "clip")
        mixed = cleaned + priv                       # re-contaminated
        return taint.boundary(mixed.sum())

    rep = taint.analyze(mix, frozenset({"clip"}), torch.zeros(3))
    assert not rep.ok and rep.violations[0].missing == frozenset({"clip"})


def test_taint_follows_views_and_in_place_ops():
    """Labels live on the storage: a view of a tainted tensor is tainted,
    and an in-place op writes the join onto its target."""
    def f(x, clean):
        priv = taint.tag_private(x)
        clean.add_(priv[:2])                   # clean buffer now tainted
        return taint.boundary(clean.view(-1))

    rep = taint.analyze(f, frozenset({"clip"}), torch.ones(4),
                        torch.zeros(2))
    assert not rep.ok and rep.checked == 1


def test_taint_markers_are_production_noops():
    """Outside an analysis the markers return the same object and
    dispatch no op."""
    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    t, tree = torch.ones(2), {"a": torch.zeros(3)}
    with Ops() as rec:
        assert taint.tag_private(t) is t
        assert taint.declassify(t, "clip", wire="int8+scale") is t
        assert taint.boundary(tree) is tree
    assert rec.ops == []


def test_taint_multi_step_local_update_catches_loop_carried_taint():
    """The reference's scan-carry case as the port runs it: a multi-step
    local update whose every step folds the private value into the carried
    weights.  Eager loops run every trip, so the carry is tainted at the
    boundary."""
    def local_steps(w, x):
        priv = taint.tag_private(x)
        for _ in range(3):
            grad = 2.0 * (w - priv)
            w = w - 0.1 * grad                       # taint enters carry
        return taint.boundary(w.sum())

    rep = taint.analyze(local_steps, frozenset({"clip"}), torch.zeros(3),
                        torch.ones(3))
    assert not rep.ok, "loop-carried taint escaped the multi-step walk"


def test_untagged_loss_release_is_not_flagged():
    """The weighted scalar loss release (the accepted disclosure) carries
    no taint, so the identity config is clean AND non-vacuous."""
    rep = taint.verify_pipeline("vmap", TransformConfig(), device=CPU)
    assert rep.proved, rep.render()
    assert rep.required == frozenset()
    assert [c.tainted for c in rep.crossings][0] is False   # the weights
    assert [c.tainted for c in rep.crossings][-1] is False  # the loss


def test_tainted_host_read_before_the_boundary_is_a_violation():
    """Fail closed: a Python number made from an unsanitized private value
    leaves the dispatcher's view, so the read itself is the violation."""
    def leak(x):
        priv = taint.tag_private(x)
        scale = float(priv.abs().max())              # host read, raw
        return taint.boundary(taint.declassify(priv / scale, "clip"))

    rep = taint.analyze(leak, frozenset({"clip"}), torch.ones(3))
    assert not rep.ok
    assert any(v.primitive == "host_read:_local_scalar_dense"
               for v in rep.violations), rep.render()


def test_host_alias_reentry_carries_taint_and_is_a_violation():
    """``.numpy()`` is invisible to the dispatcher; a tensor made back from
    that array (``from_numpy``) aliases the tainted storage, is flagged,
    and keeps the taint."""
    def launder(x):
        priv = taint.tag_private(x)
        back = torch.from_numpy(priv.numpy())        # shares the memory
        return taint.boundary(back * 1.0)

    rep = taint.analyze(launder, frozenset({"clip"}), torch.ones(3))
    assert any(v.primitive == "host_alias" for v in rep.violations)
    assert any(v.primitive == "boundary" for v in rep.violations)


def test_kernel_launch_after_the_source_is_a_violation():
    """A ctypes kernel launch is invisible to the tracer, so a launch after
    the first tag_private fails the proof (counted through the launch
    counters every wrapper increments)."""
    def late_kernel(x):
        priv = taint.tag_private(x)
        _cuda.LAUNCHES["lstm_cell"] += 1             # as a wrapper would
        return taint.boundary(taint.declassify(priv, "clip"))

    before = _cuda.LAUNCHES["lstm_cell"]
    try:
        rep = taint.analyze(late_kernel, frozenset({"clip"}), torch.ones(3))
    finally:
        _cuda.LAUNCHES["lstm_cell"] = before
    assert rep.launches_after_source == 1 and not rep.ok


# ----------------------------------------------------- hot-path guards
def test_round_hot_path_no_recompiles_no_host_reads():
    report, err, _ = recompile.check_round_hot_path(device=CPU)
    assert report.ok, report.render()
    assert report.new_entries_per_step == [0, 0, 0]
    assert err is None, err


def test_round_hot_path_full_stack_with_masking_has_no_host_read():
    """The ring quantizer and the pairwise masker inside the guarded round:
    the masker used to count the cohort's real slots on the host
    (``nonzero``); it now gates every pair on the device."""
    report, err, _ = recompile.check_round_hot_path(
        device=CPU, tcfg=FULL_T, scfg=SECURE)
    assert report.ok, report.render()
    assert err is None, err


def test_host_read_guard_catches_a_planted_item():
    x = torch.ones(4)

    def step(i):
        y = x * (i + 1)
        return y / float(y.sum())                    # a host read a round

    err = recompile.check_transfers(step)
    assert err is not None and "_local_scalar_dense" in err


def test_host_read_guard_catches_a_boolean_mask():
    x = torch.arange(6.0)
    err = recompile.check_transfers(lambda i: x[x > i])
    assert err is not None and "boolean mask" in err


def test_recompile_guard_catches_per_step_shape_change():
    """A batch size that changes every step misses the launch-plan cache
    every step: exactly what the probe must flag."""
    def step(i):
        # a shape no other test plans: B changes with i
        return _cuda.cell_plan("lstm_cell", 1000 + 7 * i, 1, 64, 4, 131,
                               M=100)

    rep = recompile.count_recompiles(step, steps=2)
    assert not rep.ok and rep.new_entries_per_step == [1, 1]
    assert [k["plans"] for k in rep.by_kind] == [1, 1]


def test_recompile_probe_counts_graph_captures(monkeypatch):
    """CUDA graph captures count as well: the probe wraps
    ``CUDAGraph.capture_begin`` while it runs."""
    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin",
                        lambda self, *a, **kw: None)

    def step(i):
        if i:
            torch.cuda.CUDAGraph.capture_begin(object())

    rep = recompile.count_recompiles(step, steps=2)
    assert [k["captures"] for k in rep.by_kind] == [1, 1]
    assert np.sum(rep.new_entries_per_step) == 2
