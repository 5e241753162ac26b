"""The harness of the port's benchmark: one run of one cell.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` finds everything by name under portbench/:

  workloads/<cell>.json     the cell: its configuration, its traffic mix,
                            the entry of the port it drives, the entry's
                            parameters, the checks that decide `correct`
                            and their limits
  configs/<config>.json     the deployment: genome, index, scoring
  mixes/<traffic>.json      the traffic's parameters (lib/reads.py reads
                            them)
  entries/<entry>.py        the driver of one entry of the port:
                            set-up, warm-up, the window
  metrics/<metric>.py       one per-layer metric: read(trace) -> value
                            or None (left out of the line)
  reference/<check>.py      the plain reference's comparison of a run's
                            output: judge(run) -> {number: value}

A later change adds a configuration, a mix, a cell or a metric by adding
such files and a BENCHMARK.json entry; nothing here names one.

The run fails (exit code 2, no result line) without a CUDA card, with
fewer cards than the cell asks for, without the port beside the
benchmark, or when jax, jaxlib, flax or the JAX package are loaded once
the window has closed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
# top-level module names that the process must not hold (the port's name
# begins with the JAX package's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "fgdp_tpu")


class RunFailed(Exception):
    """A run that cannot give a result: exit 2, no result line."""


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def one_thread_a_process():
    """One BLAS/OpenMP thread a process, set before numpy and torch
    load (the spawned pool workers inherit it): the port's pools run a
    process a core, and each library's own thread pool in every one of
    them would contend for the same cores."""
    for v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[v] = "1"


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time in
    /proc/self/stat against /proc/uptime), so that set-up counts the
    interpreter's start as well."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(kind: str, name: str) -> dict:
    path = os.path.join(BENCH, kind, name + ".json")
    if not os.path.exists(path):
        raise RunFailed(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module portbench/<kind>/<name>.py, imported from its path
    (names may hold dots and dashes)."""
    path = os.path.join(BENCH, kind, name + ".py")
    if not os.path.exists(path):
        raise RunFailed(f"no {kind} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def cuda_device(chips: int):
    """The card the run measures; raises RunFailed without one. The
    benchmark never falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise RunFailed("no CUDA card is available: the benchmark "
                        "measures the port on the card and never runs "
                        "on the CPU")
    if torch.cuda.device_count() < chips:
        raise RunFailed(f"the cell needs {chips} cards, "
                        f"{torch.cuda.device_count()} are available")
    return torch.device("cuda", 0)


def host_line() -> str:
    """The host's CPU model, cores and load, and the card's power limit:
    host-timed rates move with them."""
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ln.startswith("model name"):
                    model = ln.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    card = "not read"
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or card
    except (OSError, subprocess.SubprocessError):
        pass
    return (f"host: {model}, {os.cpu_count()} cores, load "
            f"{' '.join(f'{x:.2f}' for x in os.getloadavg())}; card: {card}")


class Stopwatch:
    """Logs the seconds of each step of set-up."""

    def __init__(self, what: str):
        self.what = what
        self.t = time.perf_counter()

    def lap(self, step: str):
        now = time.perf_counter()
        log(f"[{self.what}] {step} {now - self.t:.3f} s")
        self.t = now


class Window:
    """The measured window. It opens after warm-up; `feed` passes the
    input on until `seconds` have passed, then ends it; the window
    closes when the entry returns, after everything in flight has
    drained. If the input ends first, the window ends there."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.t_open = self.t_close = None
        self.fed = 0            # units of work passed on
        self.ran_dry = False

    def open(self):
        self.cpu_open = time.process_time()
        self.t_open = time.perf_counter()

    def close(self):
        self.t_close = time.perf_counter()
        # the port's main process runs the path's host work: its CPU
        # seconds over the window, in cores
        cpu = time.process_time() - self.cpu_open
        log(f"[host] the window: this process {cpu:.1f} CPU s "
            f"({cpu / self.length:.2f} cores)")

    @property
    def length(self) -> float:
        return self.t_close - self.t_open

    def feed(self, items, units):
        """Yield items until the deadline; units(item) is the work an
        item carries (counted as it is passed on)."""
        deadline = self.t_open + self.seconds
        for item in items:
            if time.perf_counter() >= deadline:
                return
            self.fed += units(item)
            yield item
        self.ran_dry = True


class Context:
    """What an entry needs: the cell, its configuration and mix, the
    run's arguments, the card, a scratch directory under TMPDIR, and the
    trace (None when --trace 0)."""

    def __init__(self, args, cell, config, mix, device, tracer):
        self.args = args
        self.seed = args.seed
        self.cell = cell
        self.config = config
        self.mix = mix
        self.device = device
        self.tracer = tracer
        self.params = cell.get("params", {})
        self.tmp = tempfile.mkdtemp(prefix="portbench-")
        self.window = Window(args.seconds)

    def cleanup(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


def parse_args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def bench_metrics(trace: int) -> dict:
    """BENCHMARK.json's metrics of this kind ({name: entry})."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    return {m["name"]: m for m in b["per_layer" if trace else "end_to_end"]}


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def judge(ctx, run) -> tuple:
    """(correct, {number: (value, limit)}): every number of the cell's
    checks against its limit (a number passes when it is at most its
    limit). Numbers that have no limit are logged as readings."""
    numbers = {}
    for check in ctx.cell["checks"]:
        numbers.update(load_module("reference", check).judge(ctx, run))
    limits = ctx.cell["limits"]
    missing = set(limits) - set(numbers)
    if missing:
        raise RunFailed(f"the checks gave no number for {sorted(missing)}")
    for k in sorted(set(numbers) - set(limits)):
        log(f"reading {k} = {numbers[k]} (not compared)")
    table = {k: (numbers[k], limits[k]) for k in limits}
    return all(v <= lim for v, lim in table.values()), table


def main(argv=None, device_fn=cuda_device) -> int:
    """One run; returns the exit code. `device_fn(chips)` gives the
    card (the harness's tests put the CPU there)."""
    args = parse_args(argv)
    ctx = None
    try:
        cell = load_json("workloads", args.workload)
        device = device_fn(cell["chips"])
        if not os.path.isdir(os.path.join(ROOT, "fgdp_tpu_torch")):
            raise RunFailed("the port (fgdp_tpu_torch) is not beside the "
                            f"benchmark in {ROOT}")
        if ROOT not in sys.path:
            sys.path.insert(0, ROOT)
        config = load_json("configs", cell["config"])
        mix = load_json("mixes", cell["traffic"])
        tracer = None
        if args.trace:
            from . import trace
            tracer = trace.Tracer()
        log(host_line())
        ctx = Context(args, cell, config, mix, device, tracer)
        entry = load_module("entries", cell["entry"])
        run = entry.run(ctx)
        found = forbidden_modules()
        if found:
            raise RunFailed(f"modules loaded in the run's process: {found}")
        return report(ctx, run)
    except RunFailed as e:
        log(f"portbench: {e}")
        return 2
    finally:
        if ctx is not None:
            ctx.cleanup()


def report(ctx, run) -> int:
    """Judge the run's output, then print the numbers compared and the
    result line."""
    w = ctx.window
    if w.ran_dry:
        log(f"[window] the input ran out after {w.fed} {run.fed_unit} in "
            f"{w.length:.3f} s: the window ended there; the rate is all "
            "the work over all the time")
    t0 = time.perf_counter()
    correct, table = judge(ctx, run)
    log(f"[reference] {time.perf_counter() - t0:.3f} s")
    metrics = {}
    if ctx.args.trace:
        t = ctx.tracer
        t.finish(ctx, run)
        for name, m in bench_metrics(1).items():
            if not applies(m, ctx.cell["name"]):
                continue
            v = load_module("metrics", name).read(t)
            if v is not None:
                metrics[name] = {"value": v, "unit": m["unit"]}
    else:
        for name, m in bench_metrics(0).items():
            if applies(m, ctx.cell["name"]) and name in run.metrics:
                metrics[name] = {"value": run.metrics[name],
                                 "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run.device_kind,
              "count": ctx.cell["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": bool(correct), "attempted": w.fed,
            "failed": int(table["missing"][0]) if "missing" in table else 0,
            "metrics": metrics, "device": device}
    if ctx.args.trace:
        device["busy_s"] = ctx.tracer.busy_s
        device["window_s"] = ctx.tracer.window_s
        line["breakdown"] = ctx.tracer.breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in table.items()}
    for k, (v, lim) in table.items():
        log(f"check {k} = {v} (limit {lim}): "
            f"{'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0
