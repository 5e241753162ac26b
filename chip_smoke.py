#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fgdp_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and fails (non-zero exit, no result line) when
there is none or when the port is not beside it. Phases, each of which
fails loudly:
  1. card     name and power limit (nvidia-smi), torch and CUDA versions
  2. build    the hand-written kernels from fgdp_tpu_torch/csrc (nvcc)
  3. kernels  each kernel against its plain PyTorch version on the card
              at the main path's shapes (seeded inputs, exact equality)
  4. golden   `index` + `mem` on the golden fixtures, field-compared with
              the reference aligner's SAM like tests/test_golden.py
  5. ladder   a tight-capacity batch through every escalation rung on
              the card, equal to the port's CPU run
  6. scale    BASELINE config 1 at E. coli size: a 4.6 Mb repeat-rich
              reference (scripts/gen_genome.py's generator) and 16,384
              single-end 151 bp reads; launch counts, reads/s, per-stage
              ms, peak device memory, and placement accuracy
Then one JSON line of the kernels, the card line, and the result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s
# and the non-tensor-core 32-bit rate the integer DP is counted against
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
SW_OPS_PER_CELL = 20      # int32 operations per DP cell (sw_extend.cuh)
CHAIN_OPS_PER_SLOT = 6    # per seed step and chain slot (chain_loop.cuh)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ data

def gen_genome(n, seed=0):
    """Repeat-rich synthetic genome from scripts/gen_genome.py (isochore
    background, Alu-like and LINE-like families, microsatellites,
    segmental duplications)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gen_genome", os.path.join(ROOT, "scripts", "gen_genome.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.generate(n, seed)


def sim_reads(g, n_reads, L, seed=1):
    """Single-end reads from both strands: 1% substitutions, one short
    indel in a tenth of them. Names carry the true leftmost position."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_reads):
        p = int(rng.integers(0, len(g) - L - 8))
        s = g[p:p + L + 8].copy()
        if rng.random() < 0.1:
            k = int(rng.integers(20, L - 20))
            d = int(rng.integers(1, 4))
            if rng.random() < 0.5:
                s = np.concatenate([s[:k], s[k + d:]])
            else:
                s = np.concatenate([s[:k], rng.integers(0, 4, d)
                                    .astype(np.uint8), s[k:]])
        s = s[:L]
        m = rng.random(L) < 0.01
        s[m] = (s[m] + rng.integers(1, 4, int(m.sum()))) % 4
        rev = rng.random() < 0.5
        if rev:
            s = (3 - s)[::-1]
        out.append((f"r{i}_{p + 1}_{'-' if rev else '+'}", s))
    return out


def write_fasta(path, name, codes):
    seq = np.frombuffer(b"ACGTN", np.uint8)[codes].tobytes().decode()
    with open(path, "w") as f:
        f.write(f">{name}\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + "\n")


def write_fastq(path, reads):
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "w") as f:
        for name, s in reads:
            f.write(f"@{name}\n{lut[s].tobytes().decode()}\n+\n"
                    f"{'I' * len(s)}\n")


def sw_inputs(seed, J, QP, TP):
    """Banded-SW jobs shaped like the main path's: empty, short and long
    lanes, targets that copy the query with a few errors (long
    extensions) or turn random part-way (z-drop), N bases; lanes sorted
    by query length as extend_chains sorts them."""
    rng = np.random.default_rng(seed)
    kind = rng.random(J)
    qlen = np.where(kind < 0.1, 0, np.where(
        kind < 0.55, rng.integers(1, 21, J),
        np.where(kind < 0.65, rng.integers(21, 100, J),
                 rng.integers(100, QP + 1, J)))).astype(np.int32)
    q = rng.integers(0, 4, (J, QP)).astype(np.int32)
    t = rng.integers(0, 4, (J, TP)).astype(np.int32)
    shift = rng.integers(0, 4, J)
    for j in range(4):
        rows = shift == j
        t[rows, j:j + QP] = q[rows]
    mis = rng.random((J, TP)) < 0.02
    t[mis] = rng.integers(0, 4, int(mis.sum()))
    zd = rng.random(J) < 0.15                       # copy stops: z-drop
    cut = rng.integers(10, QP, J)
    cols = np.arange(TP)[None, :]
    t = np.where(zd[:, None] & (cols >= cut[:, None]),
                 rng.integers(0, 4, (J, TP)), t)
    q[rng.random((J, QP)) < 0.005] = 4
    t[rng.random((J, TP)) < 0.005] = 4
    tlen = np.minimum(qlen + rng.integers(0, 2 * 100 + 1, J), TP)
    tlen[rng.random(J) < 0.03] = 0
    h0 = rng.integers(19, 80, J).astype(np.int32)
    order = np.argsort(qlen, kind="stable")
    return (q[order], qlen[order], t[order], tlen[order].astype(np.int32),
            h0[order])


def chain_inputs(seed, B, P, l_pac):
    """Chain-loop seed columns shaped like expand_seeds' output: per read
    a prefix of valid slots (most reads a few, repeat reads up to P),
    qbeg ascending, diagonal runs with jumps, contained repeats, both
    strands."""
    rng = np.random.default_rng(seed)
    nval = np.minimum(rng.geometric(0.08, B), P)
    nval[rng.random(B) < 0.02] = P
    qbeg = np.sort(rng.integers(0, 140, (B, P)), axis=1).astype(np.int32)
    diag = rng.integers(0, 2 * l_pac - 400, (B, 1))
    jump = rng.integers(0, 2 * l_pac - 400, (B, P))
    rbeg = np.where(rng.random((B, P)) < 0.6, diag + qbeg, jump)
    rbeg = (rbeg + rng.integers(-3, 4, (B, P))).clip(0).astype(np.int32)
    slen = rng.integers(19, 60, (B, P)).astype(np.int32)
    dup = rng.random((B, P)) < 0.2
    qbeg[:, 1:] = np.where(dup[:, 1:], qbeg[:, :-1], qbeg[:, 1:])
    rbeg[:, 1:] = np.where(dup[:, 1:], rbeg[:, :-1], rbeg[:, 1:])
    rid = (rbeg >= l_pac).astype(np.int32)
    valid = (np.arange(P)[None, :] < nval[:, None]) & \
        (rng.random((B, P)) < 0.95)
    ovf = rng.random(B) < 0.01
    return qbeg, rbeg, slen, rid, valid, ovf


# ------------------------------------------------------------ measuring

def cuda_ms(fn, reps=5):
    """Mean ms per call over `reps` launches after a warm-up, by CUDA
    events."""
    import torch
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def wall_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def max_abs_err(a, b):
    import torch
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


# ---------------------------------------------------------------- phases

def phase_card():
    import torch
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    card = q.stdout.strip().splitlines()[0] if q.returncode == 0 \
        and q.stdout.strip() else f"nvidia-smi failed: {q.stderr.strip()}"
    log(f"[card] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
        f" x{torch.cuda.device_count()}")
    return card


def phase_build():
    from fgdp_tpu_torch.ops import kernels
    secs = kernels.build()
    log(f"[build] kernels built in {secs:.1f} s (all nvcc in parallel)")
    for name, rec in kernels.build_log.items():
        for ln in rec["log"].splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build] {name}: {ln.strip()}")
    for name in kernels.KERNELS:
        kernels.load(name)


def phase_kernels(dev):
    """Each kernel against its plain version at main-path shapes."""
    import torch
    from fgdp_tpu_torch.align import chain
    from fgdp_tpu_torch.config import AlignConfig, BatchShapes
    from fgdp_tpu_torch.ops import sw

    opt = AlignConfig()
    shp = BatchShapes(batch_reads=4096)
    rows = {}

    # --- banded SW: J = 4096 reads x 6 jobs, QP = 151, TP = 368 ---
    J = shp.batch_reads * 6
    QP, TP = shp.read_len, shp.max_ext_ref
    q, qlen, t, tlen, h0 = (torch.as_tensor(a, device=dev)
                            for a in sw_inputs(11, J, QP, TP))
    p = sw.SWParams(opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
                    opt.pen_clip5, opt.a, opt.b)
    for w in (opt.w, 2 * opt.w):
        cells = torch.zeros(J, dtype=torch.int64, device=dev)
        got = sw.sw_extend_kernel(q, qlen, t, tlen, h0, w, p, cells=cells)
        plain_ms, want = wall_ms(
            lambda: sw.sw_extend_plain(q, qlen, t, tlen, h0, w, p))
        err = max_abs_err(got, want)
        ms = cuda_ms(lambda: sw.sw_extend_kernel(q, qlen, t, tlen, h0, w,
                                                 p))
        n_cells = int(cells.sum())
        nbytes = 4 * (q.numel() + t.numel() + 3 * J + 6 * J)
        t_bytes = 1e3 * nbytes / PEAK_BYTES
        t_ops = 1e3 * n_cells * SW_OPS_PER_CELL / PEAK_OPS
        log(f"[kernels] sw_extend J={J} QP={QP} TP={TP} w={w}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms, cells {n_cells}, "
            f"equal: {err == 0}")
        if err != 0:
            raise AssertionError(f"sw_extend w={w} differs from its plain "
                                 f"version (max abs err {err})")
        if w == opt.w:
            rows["sw_extend"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")

    # --- chain loop: main shape and one escalated shape ---
    l_pac = 2_300_000
    for B, P, C in ((shp.batch_reads, shp.max_seeds, shp.max_chains),
                    (1024, 1024, 128)):
        cols = chain_inputs(5 + P, B, P, l_pac)
        args = [torch.as_tensor(a, device=dev) for a in cols]
        run = lambda: chain.chain_loop_kernel(*args, l_pac, C, opt.w,
                                              opt.max_chain_gap)
        got = run()
        plain_ms, want = wall_ms(lambda: chain.chain_loop_plain(
            *args, l_pac, C, opt.w, opt.max_chain_gap))
        keys = sorted(want)
        err = max_abs_err([got[k] for k in keys], [want[k] for k in keys])
        ms = cuda_ms(run)
        valid = cols[4]
        t_last = np.where(valid.any(1), P - np.argmax(valid[:, ::-1], 1), 0)
        steps = int(t_last.sum())
        nbytes = B * P + 4 * 4 * steps + B + \
            4 * (B * C * len(chain.LOOP_FIELDS) + B + B * P) + B
        t_bytes = 1e3 * nbytes / PEAK_BYTES
        t_ops = 1e3 * steps * C * CHAIN_OPS_PER_SLOT / PEAK_OPS
        log(f"[kernels] chain_loop B={B} P={P} C={C}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.1f} ms, seed steps {steps}, "
            f"equal: {err == 0}")
        if err != 0:
            raise AssertionError(f"chain_loop P={P} C={C} differs from its "
                                 f"plain version (max abs err {err})")
        if P == shp.max_seeds:
            rows["chain_loop"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    return rows


def _index_sam(lines):
    out = {}
    for ln in lines:
        if ln.startswith("@") or not ln.strip():
            continue
        f = ln.rstrip("\n").split("\t")
        flag = int(f[1])
        if flag & 0x900:
            continue
        out[(f[0], flag & 0xC0)] = f
    return out


def _compare(ref_lines, our_lines, min_core, min_full):
    """tests/test_golden.py's field compare: CORE fields (FLAG RNAME POS
    MAPQ CIGAR) and the NM/MD/AS/XS tags, with the same minimum counts."""
    ref, ours = _index_sam(ref_lines), _index_sam(our_lines)
    if len(ours) != len(ref):
        raise AssertionError(f"{len(ours)} primary records, oracle has "
                             f"{len(ref)}")
    core = full = 0
    for key, rf in ref.items():
        of = ours.get(key)
        if of is None:
            raise AssertionError(f"read {key} missing")
        c = rf[1:6] == of[1:6]
        tr = {x.split(":")[0]: x for x in rf[11:]}
        to = {x.split(":")[0]: x for x in of[11:]}
        core += c
        full += c and all(tr.get(k) == to.get(k)
                          for k in ("NM", "MD", "AS", "XS"))
    if core < min_core or full < min_full:
        raise AssertionError(f"core {core} < {min_core} or full {full} < "
                             f"{min_full}")
    return core, full


def phase_golden(tmp):
    from fgdp_tpu_torch import cli
    for ref, fq, oracle, mc, mf in (
            ("ref.fa", "se.fq", "se.oracle.sam", 150, 150),
            ("rep_ref.fa", "rep.fq", "rep.oracle.sam", 80, 79)):
        prefix = os.path.join(tmp, ref + ".idx")
        out = os.path.join(tmp, fq + ".sam")
        cli.main(["index", os.path.join(GOLDEN, ref), prefix])
        cli.main(["mem", prefix, os.path.join(GOLDEN, fq), "-o", out])
        with open(out) as f:
            ours = f.read().splitlines()
        with open(os.path.join(GOLDEN, oracle)) as f:
            core, full = _compare(f.read().splitlines(), ours, mc, mf)
        log(f"[golden] {fq}: core fields {core}, with tags {full} "
            f"(need {mc}/{mf}) ok")


def _load_fastq(path):
    from fgdp_tpu_torch.io.fastq import parse_fastq_records
    from fgdp_tpu_torch.utils import dna
    names, seqs, quals = [], [], []
    for name, _, seq, q in parse_fastq_records(path):
        names.append(name)
        seqs.append(dna.encode(seq).astype(np.int64))
        quals.append(q.decode())
    return names, seqs, quals


class EscCounter:
    """Counts kernel launches made inside escalated rungs."""

    def __init__(self, aligner):
        from fgdp_tpu_torch.ops import kernels
        self.kernels = kernels
        self.launches = {k: 0 for k in kernels.KERNELS}
        self.rungs = []
        inner = aligner._esc_exec

        def spy(flavor, level, *a):
            before = dict(kernels.LAUNCHES)
            out = inner(flavor, level, *a)
            for k in self.launches:
                self.launches[k] += kernels.LAUNCHES[k] - before[k]
            self.rungs.append((flavor, level))
            return out

        aligner._esc_exec = spy


def phase_ladder(dev):
    """Tight caps push most reads through every rung of the overflow
    ladder; the card's SAM must equal the port's CPU SAM."""
    from fgdp_tpu_torch.config import BatchShapes
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.pipeline import Aligner

    shapes = BatchShapes(read_len=100, batch_reads=64, max_smems=1,
                         max_seeds=8, max_chains=2, max_regs=3,
                         transfer_regs=2, pack_cap=1, max_ext_ref=304)
    pref = PackedReference.from_fasta(os.path.join(GOLDEN, "rep_ref.fa"))
    fm = FMIndex.build(pref.codes)
    names, seqs, quals = _load_fastq(os.path.join(GOLDEN, "rep.fq"))
    names, seqs, quals = names[:64], seqs[:64], quals[:64]
    gpu = Aligner(pref, fm, shapes=shapes, device=dev)
    cnt = EscCounter(gpu)
    ours = gpu.align_batch(names, seqs, quals)
    want = Aligner(pref, fm, shapes=shapes, device="cpu").align_batch(
        names, seqs, quals)
    rungs = sorted(set(cnt.rungs))
    log(f"[ladder] {gpu.esc_reads} escalated reads, rungs {rungs}, "
        f"launches in rungs {cnt.launches}, equal to CPU: {ours == want}")
    if ours != want:
        raise AssertionError("escalated reads on the card differ from the "
                             "CPU run")
    if set(rungs) != {("cw", 1), ("cw", 2), ("full", 2), ("k2w", 1)}:
        raise AssertionError(f"ladder reached only {rungs}")
    if min(cnt.launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched in the escalated "
                             f"rungs: {cnt.launches}")


def phase_scale(dev, tmp, genome_bp, n_reads, batch):
    import torch
    from fgdp_tpu_torch import cli
    from fgdp_tpu_torch.ops import kernels
    from fgdp_tpu_torch.pipeline_stream import stream_mem
    from fgdp_tpu_torch.utils.profiling import PROF, WORKER_SAM

    L = 151
    t0 = time.time()
    g = gen_genome(genome_bp, seed=0)
    reads = sim_reads(g, n_reads, L, seed=1)
    fa = os.path.join(tmp, "ecoli_like.fa")
    fq = os.path.join(tmp, "reads.fq")
    write_fasta(fa, "chr", g)
    write_fastq(fq, reads)
    log(f"[scale] data: {genome_bp} bp reference, {n_reads} x {L} bp "
        f"reads, made in {time.time() - t0:.1f} s")
    prefix = os.path.join(tmp, "ecoli_like")
    t0 = time.time()
    cli.main(["index", fa, prefix])
    t_index = time.time() - t0

    aligner = cli.load_aligner(prefix, batch, opt=None, device=dev)
    aligner.stage_ms = {}
    aligner.esc_stage_ms = {}
    esc = EscCounter(aligner)
    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fin0 = PROF.acc.get(WORKER_SAM, 0.0)
    kernels.reset_launches()
    t0 = time.time()
    n = stream_mem(aligner, cli.read_batches([fq], batch), lines.append)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_batches = -(-n // batch)
    fin_ms = 1e3 * (PROF.acc.get(WORKER_SAM, 0.0) - fin0) / n_batches
    stage = {k: round(v / n_batches, 3)
             for k, v in aligner.stage_ms.items()}
    log(f"[scale] index build {t_index:.2f} s")
    log(f"[scale] mem: {n} reads in {wall:.2f} s = {n / wall:.1f} reads/s "
        f"end to end (batch {batch}, stages synchronised for timing)")
    log(f"[scale] per batch ms: {json.dumps(stage)}; host finalize "
        f"{fin_ms:.1f}; escalated stage ms total "
        f"{json.dumps({k: round(v, 1) for k, v in aligner.esc_stage_ms.items()})}")
    log(f"[scale] escalated reads {aligner.esc_reads} in "
        f"{aligner.esc_calls} rung calls {sorted(set(esc.rungs))}; "
        f"launches {launches}, of which in rungs {esc.launches}")
    log(f"[scale] peak device memory {peak / 2**30:.2f} GiB")

    # placement accuracy against the simulated truth
    prim = [ln.split("\t") for ln in lines
            if ln and not ln.startswith("@")
            and not int(ln.split("\t")[1]) & 0x900]
    if len(prim) != n_reads or len({f[0] for f in prim}) != n_reads:
        raise AssertionError(f"{len(prim)} primary records for {n_reads} "
                             "reads")
    mapped = [f for f in prim if not int(f[1]) & 4]
    confident = [f for f in mapped if int(f[4]) >= 20]
    right = sum(abs(int(f[3]) - int(f[0].split("_")[1])) <= 10
                for f in confident)
    frac_right = right / max(len(confident), 1)
    log(f"[scale] mapped {len(mapped)}/{n_reads}, MAPQ>=20 "
        f"{len(confident)}, of which at the true position "
        f"{frac_right:.4f}")
    if len(mapped) < 0.9 * n_reads or frac_right < 0.95:
        raise AssertionError("scale run placed too few reads correctly")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched on the main "
                                 "path")
    if aligner.esc_reads and min(esc.launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched in the escalated "
                             f"rungs: {esc.launches}")
    return launches


PHASES = ("kernels", "golden", "ladder", "scale")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                         f"{','.join(PHASES)} (card and build always run);"
                         " a partial run prints no result line")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phase in {args.phases}")
    if not os.path.isdir(os.path.join(ROOT, "fgdp_tpu_torch")):
        print("chip_smoke: the fgdp_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda")
    t_start = time.time()
    card = phase_card()
    phase_build()
    if "kernels" in phases:
        rows = phase_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="fgdp_smoke_") as tmp:
        if "golden" in phases:
            phase_golden(tmp)
        if "ladder" in phases:
            phase_ladder(dev)
        if "scale" in phases:
            launches = phase_scale(dev, tmp, genome_bp=4_600_000,
                                   n_reads=16_384, batch=4096)
    if phases != set(PHASES):
        log(f"[done] phases {sorted(phases)} passed in "
            f"{time.time() - t_start:.1f} s (partial run: no result)")
        print(card)
        return 0
    meta = {
        "sw_extend": ("cuda", "fgdp_tpu_torch/csrc/sw_extend.cu",
                      "fgdp_tpu/ops/sw_pallas.py:34"),
        "chain_loop": ("cuda", "fgdp_tpu_torch/csrc/chain_loop.cu",
                       "fgdp_tpu/ops/chain_pallas.py:40"),
    }
    out = []
    for name, (route, src, repl) in meta.items():
        r = rows[name]
        out.append(dict(name=name, route=route, source=src, replaces=repl,
                        launches=launches[name],
                        max_abs_err=r["max_abs_err"], ms=r["ms"],
                        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"], library_ms=None))
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
