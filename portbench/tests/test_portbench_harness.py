"""The harness around the cells: the import guard, BENCHMARK.json against
the benchmark's contract, a run without a card, discovery of new cells,
configurations and metrics by their files alone, and the result line."""

import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from harness import guard

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name, banned", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("orbslam3_tpu", True), ("orbslam3_tpu.engine.system", True),
    ("orbslam3_tpu_torch", False), ("orbslam3_tpu_torch.engine.system", False),
    ("jaxtyping", False), ("flaxen", False), ("torch", False)])
def test_guard_compares_whole_top_level_names(name, banned):
    assert guard.banned_modules([name, "numpy"]) == ([name] if banned else [])


def test_benchmark_json_meets_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"][:2] == ["python3", "portbench/run.py"] and len(b["command"]) <= 32
    assert 1 <= len(b["paths"]) <= 16 and all((ROOT / p).is_dir() for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16 and c["file"].startswith("portbench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    names = {c["name"] for c in b["configs"]}
    assert {w["config"] for w in b["workloads"]} == names
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = json.loads((ROOT / "portbench" / "workloads" / f"{w['name']}.json").read_text())
        assert mix["config"] == w["config"] and (ROOT / "portbench" / "traffic"
                                                 / f"{mix['kind']}.py").exists()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == {"setup_s", "frames_per_s"}
    for m in b["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    layers = set()
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] == "frames_per_s" and NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        layers.add(m["layer"])
    every = {w["name"] for w in b["workloads"]}
    reported = set().union(*(set(m["workloads"]) for m in b["per_layer"]))
    assert reported == every
    assert len(json.dumps(b)) < 64 * 1024


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "euroc_mi.fast",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in out.stderr


ECHO_KIND = '''
"""A kind of traffic for the harness's test: no system, a fixed count of
answers over the window."""
import time


class Cell:
    kernels = ()

    def __init__(self, config, workload, seed, seconds, device, spans, log):
        self.p, self.spans = workload["traffic"], spans

    def setup(self):
        pass

    def window(self, seconds, tick=lambda elapsed: None):
        t0 = time.perf_counter()
        for i in range(self.p["answers"]):
            tick(time.perf_counter() - t0)
            with self.spans.span("track_monocular", client=0, frame=i) as s:
                time.sleep(seconds / self.p["answers"])
                s["ok"] = True
        return dict(t0=t0, t1=time.perf_counter(), attempted=self.p["answers"], failed=0,
                    poses=self.p["answers"], keyframes=1)

    def release(self):
        pass

    def judge(self):
        return {"answers": self.p["answers"]}
'''


def test_a_new_cell_configuration_and_metric_are_picked_up_from_files_alone(tmp_path):
    """A copy of the benchmark gains a cell, its configuration, its kind of
    traffic and a per-layer metric as new files and new BENCHMARK.json
    entries only; every file the benchmark had is unchanged, and a run of
    the new cell reports the new metric in a well-formed result line."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "portbench" / "configs" / "echo_config.json").write_text(json.dumps(
        {"name": "echo_config", "source": "https://example.org/echo", "reduced": []}))
    (tmp_path / "portbench" / "traffic" / "echo.py").write_text(textwrap.dedent(ECHO_KIND))
    (tmp_path / "portbench" / "workloads" / "echo.cell.json").write_text(json.dumps(
        {"config": "echo_config", "kind": "echo", "why": "a test", "k1_samples": 0,
         "k2_samples": 0, "traffic": {"answers": 4}, "limits": {"answers": 4}}))
    (tmp_path / "portbench" / "metrics" / "echo.answers_per_s.py").write_text(
        "def read(rd):\n    return rd.win['poses'] / rd.window_s\n")
    b["configs"].append({"name": "echo_config", "source": "https://example.org/echo",
                         "file": "portbench/configs/echo_config.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "echo.cell", "config": "echo_config", "traffic": "echo",
                           "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "echo.answers_per_s", "unit": "1/s", "better": "higher",
                           "source": "program_counter", "layer": "replay",
                           "moves": "frames_per_s", "workloads": ["echo.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    after = {p: p.read_bytes() for p in before}
    assert after == before
    prog = textwrap.dedent(f"""
        import argparse, json, sys
        sys.path.insert(0, {str(tmp_path / 'portbench')!r})
        sys.path.insert(1, {str(ROOT)!r})
        import run
        for trace in (0, 1):
            a = argparse.Namespace(workload="echo.cell", seed=3, seconds=0.2, trace=trace)
            print(json.dumps(run.measure(run.prepare(a, device="cpu"))))
        """)
    out = subprocess.run([sys.executable, "-c", prog], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    for res in (plain, traced):
        assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(res)[-1] == "checks" and res["checks"] == {"answers": {"value": 4.0,
                                                                         "limit": 4}}
        assert res["correct"] is True and res["attempted"] == 4 and res["failed"] == 0
        assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(plain["metrics"]) == {"frames_per_s", "setup_s"}
    assert plain["metrics"]["frames_per_s"]["unit"] == "frames/s"
    # the metrics there were name their cells, so the new cell reports its own
    assert set(traced["metrics"]) == {"echo.answers_per_s"}
    assert traced["metrics"]["echo.answers_per_s"]["value"] == pytest.approx(20, rel=0.5)
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
