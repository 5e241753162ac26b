"""The configuration's genome and the port's index of it, cached.

The cache lives in a fixed directory inside the checkout,
portbench/cache/index/<config>-<key>/, git-ignored. The key hashes the
configuration's file, the benchmark's genome generator and the port's
index-building sources (fgdp_tpu_torch/index/*.py and the native SA-IS
and LCP source), so a change to the port's index builder rebuilds
instead of reading a stale index. Only a cell's first run in a checkout
builds; later runs load, as users run `index` once and `mem` many times.

Files: genome.npy (the benchmark's own draw, which the plain reference
reads too) and the port's index under the prefix `index`: index.ref.npz,
index.fmi.npz and, for an index with the LCP tree, index.lcp.npz (the
formats and names `python -m fgdp_tpu_torch index <fa> <prefix>`
writes).
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import tempfile
import time

import numpy as np

from . import genome as genmod
from .harness import BENCH, ROOT, log

CACHE = os.path.join(BENCH, "cache", "index")


def key(config: dict, config_path: str) -> str:
    h = hashlib.sha256()
    srcs = [config_path, genmod.__file__,
            os.path.join(ROOT, "native", "fgdp_native.cc")]
    srcs += sorted(glob.glob(os.path.join(ROOT, "fgdp_tpu_torch", "index",
                                          "*.py")))
    for p in srcs:
        h.update(os.path.relpath(p, ROOT).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def ensure(config: dict) -> str:
    """The cache directory of the configuration's index, built first
    when missing."""
    cpath = os.path.join(BENCH, "configs", config["name"] + ".json")
    d = os.path.join(CACHE, f"{config['name']}-{key(config, cpath)}")
    if os.path.exists(os.path.join(d, "done")):
        return d
    os.makedirs(CACHE, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".build-", dir=CACHE)
    try:
        build(config, tmp)
        open(os.path.join(tmp, "done"), "w").close()
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(tmp, d)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return d


def build(config: dict, out: str):
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.lcptree import LcpTree
    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.utils import dna

    t0 = time.perf_counter()
    g = genmod.generate(config["genome_bp"], config["genome_seed"])
    np.save(os.path.join(out, "genome.npy"), g)
    pref = PackedReference.from_contigs([config["contig"]], [g])
    pref.save(os.path.join(out, "index.ref"))
    t1 = time.perf_counter()
    fm = FMIndex.build(pref.codes)
    fm.save(os.path.join(out, "index.fmi"))
    t2 = time.perf_counter()
    if config["index"] == "fm+lcp":
        x = np.concatenate([pref.codes, dna.revcomp(pref.codes)])
        LcpTree.build(x.astype(np.uint8), fm.sa).save(
            os.path.join(out, "index.lcp"))
    log(f"[index] {config['name']}: genome {t1 - t0:.2f} s, FM index "
        f"{t2 - t1:.2f} s, LCP tree {time.perf_counter() - t2:.2f} s")


def prefix(d: str) -> str:
    """The index's prefix, as the port's CLI takes it."""
    return os.path.join(d, "index")


def genome(d: str) -> np.ndarray:
    return np.load(os.path.join(d, "genome.npy"))
