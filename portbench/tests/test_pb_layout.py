"""The benchmark's layout: BENCHMARK.json against the contract, every
piece found by name (a throwaway configuration, mix, cell, entry, check
and metric added as files are picked up with no file edited), the
imports, and the runs that must fail."""

from __future__ import annotations

import ast
import glob
import json
import os
import re
import subprocess
import sys

import pytest

import pb_common as pc

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(pc.REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"][1] == "portbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(pc.REPO, c["file"]))
        cfg = json.load(open(os.path.join(pc.REPO, c["file"])))
        assert cfg["name"] == c["name"]
        assert all(k in cfg for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        cell = json.load(open(os.path.join(pc.BENCH, "workloads",
                                           w["name"] + ".json")))
        assert {k: cell[k] for k in w} == w
        assert os.path.exists(os.path.join(pc.BENCH, "mixes",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(pc.BENCH, "entries",
                                           cell["entry"] + ".py"))
        reported = [m for m in b["end_to_end"]
                    if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(reported) >= 2
        assert any(w["name"] in m.get("workloads", cells)
                   for m in b["per_layer"])
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert all(x in e2e[m["moves"]].get("workloads", cells)
                   for x in m["workloads"])
        assert os.path.exists(os.path.join(pc.BENCH, "metrics",
                                           m["name"] + ".py"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


def test_pieces_are_found_by_name(tmp_path):
    """A throwaway configuration, mix, cell, entry, check and metric,
    added as files beside the real ones, drive a run and reach its
    result line; no file that was there is edited."""
    root = pc.checkout(tmp_path)
    pb = os.path.join(root, "portbench")
    before = {p: open(p, "rb").read() for p in
              glob.glob(os.path.join(pb, "**", "*.*"), recursive=True)}
    pc.write_json(os.path.join(pb, "configs", "toy-cfg.json"),
                  {"name": "toy-cfg", "items": 5})
    pc.write_json(os.path.join(pb, "mixes", "toy-mix.json"),
                  {"kind": "toy", "reads": 7})
    pc.write_json(os.path.join(pb, "workloads", "toy-cell.json"),
                  {"name": "toy-cell", "config": "toy-cfg",
                   "traffic": "toy-mix", "chips": 1, "why": "a toy",
                   "entry": "toy_entry", "checks": ["toy_check"],
                   "sample": 1, "limits": {"missing": 0}})
    with open(os.path.join(pb, "entries", "toy_entry.py"), "w") as f:
        f.write(
            "import types\n"
            "def run(ctx):\n"
            "    w = ctx.window\n"
            "    w.open()\n"
            "    items = range(ctx.mix['reads'] * ctx.config['items'])\n"
            "    n = sum(1 for _ in w.feed(items, lambda i: 1))\n"
            "    w.close()\n"
            "    if ctx.tracer is not None:\n"
            "        ctx.tracer.counters['toy'] = n\n"
            "        ctx.tracer.work = n\n"
            "    return types.SimpleNamespace(\n"
            "        unit='items', fed_unit='items', memory_peak_bytes=1,\n"
            "        device_kind='toy',\n"
            "        metrics={'reads_per_s': n / w.length, 'setup_s': 1.0},\n"
            "        fed=n)\n")
    with open(os.path.join(pb, "reference", "toy_check.py"), "w") as f:
        f.write("def judge(ctx, run):\n"
                "    return {'missing': 35 - run.fed}\n")
    with open(os.path.join(pb, "metrics", "toy.metric.py"), "w") as f:
        f.write("def read(t):\n"
                "    return t.counters.get('toy')\n")
    bpath = os.path.join(root, "BENCHMARK.json")
    b = json.load(open(bpath))
    b["workloads"].append({"name": "toy-cell", "config": "toy-cfg",
                           "traffic": "toy-mix", "chips": 1,
                           "why": "a toy"})
    b["end_to_end"][0]["workloads"].append("toy-cell")
    b["per_layer"].append({"name": "toy.metric", "unit": "items",
                           "better": "higher", "source": "program_counter",
                           "layer": "toy", "moves": "reads_per_s",
                           "workloads": ["toy-cell"]})
    pc.write_json(bpath, b)
    rc, line, err = pc.run_cpu(root, ["--workload", "toy-cell", "--seed",
                                      "3", "--seconds", "60", "--trace",
                                      "0"])
    assert rc == 0, err
    assert line["correct"] and line["attempted"] == 35
    assert set(line["metrics"]) == {"reads_per_s", "setup_s"}
    assert list(line)[-1] == "checks"
    assert line["checks"] == {"missing": {"value": 0, "limit": 0}}
    rc, line, err = pc.run_cpu(root, ["--workload", "toy-cell", "--seed",
                                      "3", "--seconds", "60", "--trace",
                                      "1"])
    assert rc == 0, err
    assert line["metrics"] == {"toy.metric": {"value": 35,
                                              "unit": "items"}}
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


FORBIDDEN = {"jax", "jaxlib", "flax", "fgdp_tpu"}


def test_no_jax_in_sources():
    """No source under portbench/ imports jax, jaxlib, flax or the JAX
    package, by whole top-level name (fgdp_tpu_torch begins with
    fgdp_tpu); the reference imports nothing of the port either."""
    for path in glob.glob(os.path.join(pc.BENCH, "**", "*.py"),
                          recursive=True):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, path
        if os.sep + "reference" + os.sep in path:
            assert "fgdp_tpu_torch" not in tops, path


def test_no_jax_loaded_by_a_run():
    """What run.py and every entry, check and metric load, the port's
    modules that the entries reach included, holds no forbidden name."""
    code = (
        "import glob, os, sys\n"
        f"sys.path[:0] = [{pc.BENCH!r}, {pc.REPO!r}]\n"
        "from lib import harness, aligners, index_cache, trace\n"
        "for kind in ('entries', 'metrics', 'reference'):\n"
        f"    for p in glob.glob(os.path.join({pc.BENCH!r}, kind, '*.py')):\n"
        "        n = os.path.basename(p)[:-3]\n"
        "        if n not in ('__init__', 'control'):\n"
        "            harness.load_module(kind, n)\n"
        "import fgdp_tpu_torch.cli, fgdp_tpu_torch.pipeline_stream\n"
        "import fgdp_tpu_torch.pipeline, fgdp_tpu_torch.ops.kernels\n"
        "import fgdp_tpu_torch.index.fmindex, fgdp_tpu_torch.index.lcptree\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert not set(eval(out)) & FORBIDDEN
    code = (
        "import sys\n"
        f"sys.path[:0] = [{pc.BENCH!r}]\n"
        "from reference import align, records, se_bam, pe_sam, control\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert not set(eval(out)) & (FORBIDDEN | {"fgdp_tpu_torch", "torch"})


def test_no_card_no_result():
    """Without a card the command fails with a clear message and prints
    no result line; it never runs on the CPU."""
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "ecoli-se-pipeline", "--seed", "0", "--seconds",
                        "10", "--trace", "0"], cwd=pc.REPO,
                       capture_output=True, text=True, timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


def test_fails_without_the_port(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a
    run exits non-zero with no result line."""
    root = pc.checkout(tmp_path, with_port=False)
    rc, line, err = pc.run_cpu(root, ["--workload", "ecoli-se-pipeline",
                                      "--seed", "1", "--seconds", "10",
                                      "--trace", "0"])
    assert rc != 0 and line is None
    assert "not beside the benchmark" in err
