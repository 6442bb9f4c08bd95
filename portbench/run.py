#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (`orbslam3_tpu_torch`) on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the repository root. The cell is an entry of BENCHMARK.json's
`workloads`; its traffic mix is `portbench/workloads/<cell>.json`, which
names its configuration (`portbench/configs/<config>.json`) and its kind of
traffic (`portbench/traffic/<kind>.py`). Each per-layer metric is read by
`portbench/metrics/<metric>.py`. Nothing else names a cell, a mix or a
metric, so a new one is new files and new entries in BENCHMARK.json.

A run: set-up (imports, the kernels' build or cached library, the traffic
made on the card from `--seed`, the vocabulary, the warm-up the mix
names), then the window of `--seconds`, then the reference's judgement of
what the window produced. With `--trace 0` it reports the cell's
end-to-end metrics; with `--trace 1` the per-layer ones, from one
torch.profiler trace of the window, the port's `timing` stages and
counters, and the benchmark's spans. The last line of standard output is
one JSON object; the numbers `correct` compares, beside their limits,
come last in it and last on standard error.

It exits non-zero and prints no result without a CUDA card (or fewer cards
than the cell needs), when it cannot find its files, or when JAX or the
JAX package (`orbslam3_tpu`, compared by whole top-level name) is loaded
once the window has closed.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from harness import guard, spans as spans_mod, trace as trace_mod  # noqa: E402
from harness import reference  # noqa: E402

# The traced run profiles the last TRACE_S seconds of its window: reading a
# profile of the whole 51 s window (about 3 million device ops and runtime
# calls) took 105 s and freeing it 30 s more on the card, near the 360 s a
# run may take.
TRACE_S = 20.0


def log(msg: str) -> None:
    print(f"[portbench {time.monotonic() - T_START:8.2f}s] {msg}", file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, unlisted: bool = False) -> tuple[dict, dict, dict, dict]:
    """BENCHMARK.json, the cell's entry in it, its traffic mix and its
    configuration. With `unlisted` a mix that BENCHMARK.json does not list
    (one kept for a later PR) gets the entry its own file implies: one chip,
    its configuration's file under `portbench/configs/` (the controls and
    the harness's tests; a benchmark run takes listed cells only)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    mix_file = HERE / "workloads" / f"{name}.json"
    if entry is None and unlisted and mix_file.exists():
        cfg = json.loads(mix_file.read_text())["config"]
        entry = dict(name=name, config=cfg, chips=1)
        if all(c["name"] != cfg for c in bench["configs"]):
            bench["configs"].append(dict(name=cfg, file=f"portbench/configs/{cfg}.json"))
    if entry is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    mix = json.loads(mix_file.read_text())
    if mix["config"] != entry["config"]:
        raise SystemExit(f"portbench: {name}: the mix's config {mix['config']!r} is not "
                         f"BENCHMARK.json's {entry['config']!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    return bench, entry, mix, config


def cell_metrics(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones, or with `trace`
    its per-layer ones (those listing the cell, or listing none)."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def passes(check: dict) -> bool:
    """A compared number passes when it was read and is within its limit."""
    return check["value"] is not None and check["value"] <= check["limit"]


class Readings:
    """What the per-layer readers read: the window's result, the benchmark's
    spans, the port's stage series and counters, the kernel tap's launch
    sizes and the profiler's trace."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def stage_total_ms(self, prefix: str) -> float | None:
        tot = [s["total_ms"] for n, s in self.stages.items() if n.startswith(prefix)]
        return float(sum(tot)) if tot else None


def prepare(args, device=None, overrides=None, shrink=None,
            unlisted: bool = False) -> types.SimpleNamespace:
    """Set-up: the cell's files, the card, the traffic from the seed, the
    system under test and its warm-up. `device`, `overrides` (merged into
    the traffic mix's `traffic`), `shrink` (a function of the
    configuration returning a smaller one) and `unlisted` (`load_cell`) are
    for the harness's tests and controls; the command line passes none of
    them."""
    import torch
    bench, entry, mix, config = load_cell(args.workload, unlisted)
    if shrink is not None:
        config = shrink(config)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("portbench: torch.cuda.is_available() is False; this benchmark "
                             "measures the card and does not fall back to the CPU")
        if torch.cuda.device_count() < entry["chips"]:
            raise SystemExit(f"portbench: {entry['chips']} card(s) needed, "
                             f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        log(f"card: {power_limit()}")
    device = torch.device(device)
    if overrides:
        mix = json.loads(json.dumps(mix))
        mix["traffic"].update(overrides)
    kind = load_module(HERE / "traffic" / f"{mix['kind']}.py", f"portbench_traffic_{mix['kind']}")
    from harness import port
    mods = port.modules()
    spans = spans_mod.Spans()
    cell = kind.Cell(config, mix, args.seed, args.seconds, device, spans, log)
    cell.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()
    setup_s = time.monotonic() - T_START if device.type == "cuda" else None
    log(f"set-up done: {setup_s} s")
    return types.SimpleNamespace(args=args, bench=bench, mix=mix, cell=cell, mods=mods,
                                 spans=spans, device=device, setup_s=setup_s)


def measure(ss: types.SimpleNamespace, plant=None, release: bool = True) -> dict:
    """The window of a prepared cell (`prepare`), then the judgement;
    returns the result line's object.
    `plant` (a function of the cell and the port's modules returning an
    undo function) breaks the timed path for the window: the controls and
    the harness's tests use it. With `release` the system is freed before
    the reference runs; without it the session can measure another window."""
    import torch
    args, mix, cell, mods, device = ss.args, ss.mix, ss.cell, ss.mods, ss.device
    undo = plant(cell, mods) if plant is not None else None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    timing = mods.timing
    tap = spans_mod.KernelTap(mods.hamming, mods.patch, args.seed, bool(args.trace),
                              mix["k1_samples"], mix["k2_samples"])
    prof = None
    tick = lambda elapsed: None  # noqa: E731
    if args.trace:
        timing.reset()
        timing.enable(True)
        prof = trace_mod.Profiler(cuda=device.type == "cuda", spans=ss.spans)
        tap.traced = False

        def tick(elapsed):
            if prof.started is None and elapsed >= args.seconds - TRACE_S:
                prof.start()
                tap.traced = True
    launches0 = mods.build.snapshot()
    with tap:
        win = cell.window(args.seconds, tick)
    if prof is not None:
        if prof.started is None:
            prof.start()
        t_stop = time.monotonic()
        prof.stop()
        log(f"trace: {prof.stopped - prof.started:.2f} s traced, {len(prof.trace.dev_name)} "
            f"device ops, {len(prof.trace.cpu_name)} host events, read in "
            f"{time.monotonic() - t_stop:.1f} s")
    timing.enable(False)
    if undo is not None:
        undo()
    stages = timing.stats() if args.trace else {}
    launches = {k: v - launches0.get(k, 0) for k, v in mods.build.snapshot().items()}
    window_s = win["t1"] - win["t0"]
    mem_peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    log(f"window: {window_s:.3f} s, {win['attempted']} handed in, {win['poses']} poses, "
        f"{win['keyframes']} keyframes, launches {json.dumps(launches, sort_keys=True)}")

    # the judgement, after the window, with the program's state freed
    k1 = tap.k1_host() if "k1" in cell.kernels else []
    k2 = tap.k2_host() if "k2" in cell.kernels else []
    k1_sizes = tap.k1_launch_sizes() if args.trace else []
    k2_sizes = tap.k2_launch_sizes() if args.trace else []
    tap.k1.items, tap.k2.items = [], []
    if release:
        cell.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    t_judge = time.monotonic()
    numbers = cell.judge()
    numbers["failed"] = win["failed"]
    if "k1" in cell.kernels:
        numbers["k1_rows_differ"] = reference.k1_rows_differ(k1) if k1 else math.inf
    if "k2" in cell.kernels:
        numbers["k2_values_differ"] = reference.k2_values_differ(k2) if k2 else math.inf
    log(f"reference: {time.monotonic() - t_judge:.2f} s over {len(k1)} K1 and {len(k2)} K2 "
        f"sampled launches: {json.dumps(numbers, sort_keys=True)}")
    ss.numbers = numbers
    checks = {}
    for name, limit in mix["limits"].items():
        v = numbers.get(name)
        v = None if v is None or not math.isfinite(v) else float(v)
        checks[name] = dict(value=v, limit=limit)
    correct = all(passes(c) for c in checks.values())

    metrics = {}
    if not args.trace:
        for m in cell_metrics(ss.bench, args.workload, trace=False):
            if m["name"] == "setup_s":
                metrics["setup_s"] = dict(value=ss.setup_s, unit="s")
            elif m["name"] == "frames_per_s":
                metrics["frames_per_s"] = dict(value=win["poses"] / window_s, unit="frames/s")
    else:
        tr = prof.trace
        traced = [r for r in ss.spans.records if r.get("ok") is not None
                  and r["t0"] >= prof.started and r["t1"] <= prof.stopped]
        rd = Readings(win=win, window_s=window_s, spans=ss.spans, stages=stages,
                      launches=launches, k1_sizes=k1_sizes, k2_sizes=k2_sizes, trace=tr,
                      traced_poses=sum(bool(r["ok"]) for r in traced),
                      cell=cell, cuda=device.type == "cuda")
        for m in cell_metrics(ss.bench, args.workload, trace=True):
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"].replace(".", "_"))
            got = reader.read(rd)
            if got is None:
                continue
            value, extra = got if isinstance(got, tuple) else (got, {})
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"], **extra)
        log(f"traced run: frames_per_s {win['poses'] / window_s} with the trace on")

    found = guard.banned_modules()
    if found:
        raise SystemExit(f"portbench: JAX was loaded: {', '.join(found)}")
    result = dict(correct=bool(correct), attempted=win["attempted"], failed=win["failed"],
                  metrics=metrics,
                  device=dict(platform="gpu" if device.type == "cuda" else device.type,
                              kind=torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu",
                              count=1, memory_peak_bytes=mem_peak))
    if args.trace:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = measure(prepare(args))
    for name, c in result["checks"].items():
        ok = "ok" if passes(c) else "FAILS"
        print(f"check {name} {c['value']!r} <= {c['limit']!r} {ok}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
