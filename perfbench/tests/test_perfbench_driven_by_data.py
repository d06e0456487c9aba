"""A configuration, a traffic mix, a cell and a per-layer metric are
added by new files and new entries of ``BENCHMARK.json`` alone: a copy of
the harness, with only files added to it, runs the new cell and reports
the new metric."""
import filecmp
import json
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def test_new_files_only(tmp_path):
    shutil.copytree(PKG, tmp_path / "perfbench", ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    pb = tmp_path / "perfbench"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (pb / "configs" / "tiny-k4.json").write_text(json.dumps({
        "name": "tiny-k4", "generator": "smd_like", "rows": 3000,
        "test_rows": 0, "width": 38, "clients": 8, "alpha": 0.5,
        "partition_seed": 1, "pad_rows": 0, "k_clients": 4, "k_global": 4, "h": 20,
        "fit": {"em_tol": 1e-3, "em_max_iter": 50, "reg_covar": 1e-6,
                "covariance_type": "diag"}}))
    (pb / "traffic" / "dem-separated.json").write_text(json.dumps(
        {"entry": "dem", "init": "separated"}))
    (pb / "metrics" / "local_share.py").write_text(
        "def read(t):\n"
        "    loc = t.span_s.get('local_fit')\n"
        "    return None if loc is None else 100.0 * loc / t.elapsed_s\n")
    for cell, lim in (("tiny-k4.oneshot", {
            "local_ll_gap": 10.0, "local_em_gain": 10.0, "synth_rows": 0,
            "synth_z": 100.0, "global_em_gain": 10.0}),
            ("tiny-k4.dem-separated", {"dem_ll_gap": 10.0,
                                       "dem_em_gain": 10.0})):
        (pb / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    bench["configs"].append({
        "name": "tiny-k4", "source": "https://arxiv.org/abs/2506.01780",
        "file": "perfbench/configs/tiny-k4.json", "reduced": ["rows"],
        "why": "a test"})
    bench["workloads"] += [
        {"name": "tiny-k4.oneshot", "config": "tiny-k4",
         "traffic": "oneshot", "chips": 1, "why": "a test"},
        {"name": "tiny-k4.dem-separated", "config": "tiny-k4",
         "traffic": "dem-separated", "chips": 1, "why": "a test"}]
    bench["per_layer"].append({
        "name": "local_share", "unit": "%", "better": "lower",
        "source": "program_span", "layer": "one-shot round (core/fedgen.py)",
        "moves": "fit_s", "workloads": ["tiny-k4.oneshot"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, json, time; sys.path[:0] = ['.', %r]\n"
        "from perfbench import harness\n"
        "for w in ('tiny-k4.oneshot', 'tiny-k4.dem-separated'):\n"
        "    for trace in (False, True):\n"
        "        cell = harness.load_cell(w)\n"
        "        out = harness.run_cell(cell, 5, 0.2, trace,\n"
        "            time.perf_counter(), device='cpu', require_card=False)\n"
        "        print(json.dumps([w, trace, out]))\n" % str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    runs = [json.loads(line) for line in res.stdout.splitlines()]
    assert len(runs) == 4
    for w, trace, out in runs:
        assert out["correct"], (w, out["checks"])
        assert list(out)[-1] == "checks"
        if trace and w == "tiny-k4.oneshot":
            assert "local_share" in out["metrics"]
            assert "local_fit_ms" not in out["metrics"]
        if not trace:
            assert set(out["metrics"]) == {"setup_s", "fit_s", "peak_gib"}
    # the copy differs from the harness only by the files added
    cmp = filecmp.dircmp(PKG, pb, ignore=["tests", "__pycache__"])

    def same(c):
        assert not c.diff_files and not c.left_only, (c.left, c.diff_files)
        for sub in c.subdirs.values():
            same(sub)
    same(cmp)


def test_no_result_without_a_card_or_the_program(tmp_path):
    """Here there is no card: the command exits non-zero and prints no
    result; so it does in a directory with only the benchmark's files."""
    shutil.copytree(PKG, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        res = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload",
             "smd-k10.oneshot", "--seed", "1", "--seconds", "1", "--trace",
             "0"], cwd=cwd, capture_output=True, text=True, timeout=300)
        assert res.returncode != 0 and res.stdout.strip() == ""
