"""Helpers of the benchmark's own tests: a temporary checkout holding a
copy of portbench/ and BENCHMARK.json beside the port, tiny cells to
drive on the CPU, and one run of the harness in-process."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)


def checkout(tmp, with_port=True):
    """A checkout under tmp: portbench/ (without its cache) and
    BENCHMARK.json copied, the port and its native source linked."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(BENCH, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    if with_port:
        for d in ("fgdp_tpu_torch", "native"):
            os.symlink(os.path.join(REPO, d), os.path.join(root, d))
    return root


def write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def add_tiny_cells(root):
    """Tiny CPU cells beside the real ones (added files only): a 150 kb
    genome, a few hundred reads, small batches and two finalize workers,
    for the single-end pipeline (LCP engine) and paired-end mem (sweep);
    twelve targets and two region workers for the somatic caller.
    Returns their names."""
    pb = os.path.join(root, "portbench")
    rd = lambda kind, name: json.load(open(os.path.join(pb, kind,
                                                        name + ".json")))
    cells = []
    for cfg, mix, cell, n in (("ecoli-k12", "se150_dup10",
                               "ecoli-se-pipeline", 256),
                              ("chr20", "pe150_bait5", "chr20-pe-mem", 192)):
        c = rd("configs", cfg)
        c.update(name="tiny-" + cfg, genome_bp=150_000)
        write_json(os.path.join(pb, "configs", c["name"] + ".json"), c)
        m = rd("mixes", mix)
        m.update(reads=n, dup_gap=40)
        write_json(os.path.join(pb, "mixes", "tiny-" + mix + ".json"), m)
        w = rd("workloads", cell)
        w.update(name="tiny-" + cell, config=c["name"],
                 traffic="tiny-" + mix, sample=n)
        w["params"].update(batch=64, workers=2, profile=[0, 1])
        write_json(os.path.join(pb, "workloads", w["name"] + ".json"), w)
        cells.append(w["name"])
    m = rd("mixes", "tn_exome100x50")
    m.update(targets=12)
    write_json(os.path.join(pb, "mixes", "tiny-tn_exome100x50.json"), m)
    w = rd("workloads", "chr20-somatic")
    w.update(name="tiny-chr20-somatic", config="tiny-chr20",
             traffic="tiny-tn_exome100x50", hmm_sample=64)
    w["params"].update(workers=2, profile=[0, 1])
    write_json(os.path.join(pb, "workloads", w["name"] + ".json"), w)
    cells.append(w["name"])
    bpath = os.path.join(root, "BENCHMARK.json")
    b = json.load(open(bpath))
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["tiny-" + x for x in m["workloads"]]
    write_json(bpath, b)
    return cells


@contextlib.contextmanager
def harness_of(root):
    """The harness module of the checkout at root, imported afresh."""
    pb = os.path.join(root, "portbench")
    saved = dict(sys.modules)
    sys.path.insert(0, pb)
    try:
        for m in [m for m in sys.modules if m == "lib" or
                  m.startswith("lib.") or m == "reference" or
                  m.startswith("reference.")]:
            del sys.modules[m]
        from lib import harness
        yield harness
    finally:
        sys.path.remove(pb)
        for m in [m for m in sys.modules if m not in saved]:
            if m == "lib" or m.startswith(("lib.", "reference",
                                           "portbench_")):
                del sys.modules[m]


def run_cpu(root, argv):
    """(exit code, result line or None, standard error) of one run of
    the checkout's harness on the CPU."""
    import torch
    out, err = io.StringIO(), io.StringIO()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with harness_of(root) as harness, \
                contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = harness.main(argv, device_fn=lambda chips:
                              torch.device("cpu"))
    finally:
        os.chdir(cwd)
    lines = out.getvalue().strip().splitlines()
    line = json.loads(lines[-1]) if lines and rc == 0 else None
    return rc, line, err.getvalue()
