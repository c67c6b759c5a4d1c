"""A later change adds a traffic mix, a cell and a per-layer metric as new
files plus entries in BENCHMARK.json, without editing a file that is
there: the harness of a copy of the tree finds them by name."""
import json
import shutil
import subprocess
import sys

from benchlib import harness

METRIC = '''"""A dummy reading: the window's wall in ms."""


def read(records):
    return 1e3 * records["window_s"]
'''


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    (root / "src").symlink_to(harness.ROOT / "src")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    pb = root / "portbench"
    (pb / "metrics" / "dummy_wall_ms.serve_tput.py").write_text(METRIC)
    t = json.loads((pb / "traffic" / "serve-closed-c1024.json").read_text())
    (pb / "traffic" / "serve-closed-c256.json").write_text(
        json.dumps(dict(t, in_flight=256)))
    (pb / "limits" / "serve-closed.lstm-h64.c256.json").write_text(
        (pb / "limits" / "serve-closed.gru-h64.c1024.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "serve-closed.lstm-h64.c256", "config": "lstm-h64",
        "traffic": "serve-closed-c256", "chips": 1,
        "why": "a quarter of the consumers in flight"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_forecasts_per_s":
            m["workloads"].append("serve-closed.lstm-h64.c256")
    bench["per_layer"].append({
        "name": "dummy_wall_ms.serve_tput", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "device",
        "moves": "serve_forecasts_per_s",
        "workloads": ["serve-closed.lstm-h64.c256"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    code = f"""
import sys, json
sys.path[:0] = [{str(pb)!r}, {str(pb / 'tests')!r}, {str(root / 'src')!r}]
from benchlib import harness
assert str(harness.ROOT.resolve()) == {str(root.resolve())!r}
import _small
c = _small.ctx("serve-closed.lstm-h64.c256", trace=True)
assert harness.cell_files(harness.bench_json(), "serve-closed.lstm-h64.c256"
                          )[2]["in_flight"] == 256
out = _small.run(c)
names = [m["name"] for m in harness.per_layer_for(
    harness.bench_json(), "serve-closed.lstm-h64.c256")]
print(json.dumps({{"names": names, "correct": harness.judge(out.checks),
    "dummy": harness.read_metric("dummy_wall_ms.serve_tput", out.records)}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert "dummy_wall_ms.serve_tput" in got["names"]
    assert got["correct"] and got["dummy"] > 0
    for p, b in before.items():
        if p.name != "BENCHMARK.json" and "__pycache__" not in p.parts:
            assert p.read_bytes() == b, p
