"""Mutect2-style somatic calling engine (region loop).

Mirrors the reference's callRegion flow (deepmutect Mutect2Cpp-master/
src/Mutect2Engine.cpp:168-244 and main.cpp region scheduler): activity
profile -> assembly regions -> local assembly -> PairHMM likelihoods
(ops/pairhmm.py: the card's kernel, or the plain version on the CPU) ->
somatic genotyping -> VCF records.

The region loop is pipelined: while the card computes a region's
PairHMM, the host assembles the next regions (the analogue of the
reference hiding assembly behind region parallelism). Only the main
process touches the card; the region pool's workers run host stages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import CallConfig
from ..ops import pairhmm
from . import activity, assembly, genotype

LOG10 = np.log(10.0)
DEFAULT_EMISSION_LOG10_ODDS = 3.0     # M2ArgumentCollection emissionLod
DEFAULT_NORMAL_LOG10_ODDS = 2.2
DEFAULT_GCP = 10
DEFAULT_INDEL_QUAL = 45              # GATK default ins/del qual


@dataclasses.dataclass
class VariantCall:
    contig: str
    pos: int          # 0-based
    ref: str
    alt: str
    tlod: float       # log10 tumor odds
    nlod: float | None
    depth: int
    ad_ref: int
    ad_alt: int
    af: float
    filters: tuple
    # FilterMutectCalls annotations (GATK INFO/FORMAT equivalents)
    sb: tuple = (0, 0, 0, 0)      # fwd_ref, rev_ref, fwd_alt, rev_alt
    mbq_ref: int = 30
    mbq_alt: int = 30
    mmq_ref: int = 60
    mmq_alt: int = 60
    mpos: int = 25
    mfrl: tuple = (0, 0)          # MFRL (ref, alt) medians
    mfrl_diff: float = 0.0
    ecnt: int = 1
    tumor_fmt: dict | None = None   # per-sample FORMAT stats
    normal_fmt: dict | None = None
    site_alt_lods: tuple = ()
    pop_af: float = 1e-6
    n_artifact_lod: float | None = None
    normal_ad_ref: int = 0
    normal_ad_alt: int = 0
    repeat_unit_length: int = 0
    repeat_count: int = 0
    rpa: tuple | None = None       # (ref_repeats, alt_repeats)
    repeat_unit: str = ""          # RU
    n_count: int = 0               # N bases at site (CountNs annotation)
    in_pon: bool = False           # site present in --panel-of-normals
    phasing: tuple | None = None   # (PGT, PID) genotype annotations


class _ReadIndex:
    """Coordinate-bisected span queries over a read list (reads arrive
    in BAM order; a full scan per 1 Mb region is quadratic at WGS
    scale). Reference end coordinates are precomputed once so span()
    is a pure bisect + vectorized mask."""

    def __init__(self, reads):
        self.reads = sorted(reads, key=lambda r: r["pos"])
        self.pos = np.array([r["pos"] for r in self.reads], np.int64)
        rlens = np.array(
            [max(sum(ln for op, ln in r["cigar"] if op in (0, 2, 3, 7, 8)),
                 1) for r in self.reads], np.int64)
        self.ends = self.pos + rlens
        self.max_len = int(rlens.max(initial=1))

    def span(self, start, end):
        lo = int(np.searchsorted(self.pos, start - self.max_len, "left"))
        hi = int(np.searchsorted(self.pos, end, "left"))
        keep = np.flatnonzero(self.ends[lo:hi] > start)
        return [self.reads[lo + int(k)] for k in keep]


def _read_hmm_quals(rd, pcr_cache):
    """modifyReadQualities chain for one read, memoized on the read dict
    (PairHMMLikelihoodCalculationEngine.cpp:124-147: mapq cap + low-qual
    squash + PCR-indel-error-adjusted ins/del quals)."""
    cached = rd.get("_hmm_quals")
    if cached is None:
        from .pcr_model import modify_read_quals

        cached = modify_read_quals(rd["seq_codes"],
                                   np.asarray(rd["quals"]),
                                   rd.get("mapq", 60), pcr_cache)
        rd["_hmm_quals"] = cached
    return cached


def _pairhmm_job(reads, haps, pcr_cache=None):
    """Build one region's (read, hap) pair arrays (after read dedup) or
    None when empty. Returns dict with arrays at native rmax/hmax plus
    the [H, R] reassembly info."""
    H = len(haps)
    R = len(reads)
    if H == 0 or R == 0:
        return None
    quals3 = [_read_hmm_quals(rd, pcr_cache) for rd in reads]
    keys = {}
    rep = []          # unique read indices
    col_of = np.zeros(R, np.int64)
    for i, rd in enumerate(reads):
        q3 = quals3[i]
        k = (rd["seq_codes"].tobytes(), q3[0].tobytes(), q3[1].tobytes(),
             q3[2].tobytes())
        if k in keys:
            col_of[i] = keys[k]
        else:
            keys[k] = len(rep)
            col_of[i] = len(rep)
            rep.append(i)
    ureads = [reads[i] for i in rep]
    uquals3 = [quals3[i] for i in rep]
    Ru = len(ureads)
    rmax = max(len(r["seq_codes"]) for r in ureads)
    hmax = max(len(h) for h in haps)
    NP = H * Ru
    r_arr = np.zeros((NP, rmax), np.int32)
    h_arr = np.zeros((NP, hmax), np.int32)
    rlens = np.zeros(NP, np.int32)
    hlens = np.zeros(NP, np.int32)
    q = np.zeros((NP, rmax), np.int32)
    iq = np.full((NP, rmax), DEFAULT_INDEL_QUAL, np.int32)
    dq = np.full((NP, rmax), DEFAULT_INDEL_QUAL, np.int32)
    cq = np.full((NP, rmax), DEFAULT_GCP, np.int32)
    p = 0
    for h in haps:
        for rd, (mq, miq, mdq) in zip(ureads, uquals3):
            n = len(rd["seq_codes"])
            r_arr[p, :n] = rd["seq_codes"]
            q[p, :n] = mq
            iq[p, :n] = miq
            dq[p, :n] = mdq
            rlens[p] = n
            h_arr[p, :len(h)] = h
            hlens[p] = len(h)
            p += 1
    return dict(r=r_arr, h=h_arr, rl=rlens, hl=hlens, q=q, iq=iq,
                dq=dq, cq=cq, H=H, R=R, Ru=Ru, col_of=col_of,
                rmax=rmax, hmax=hmax)


def _pairhmm_matrix_async(reads, haps, device, pcr_cache=None):
    """Single-region dispatch (no cross-region batching) on `device`;
    returns a collect() thunk yielding the [H, R] log10 matrix. Reads
    identical after quality modification share one computed column — the
    reference's read dedup (VectorLoglessPairHMM.cpp:53-114). The engine
    batches across regions (PairHMMBatcher); this is its per-region
    counterpart, which the tests hold it against."""
    job = _pairhmm_job(reads, haps, pcr_cache)
    if job is None:
        return lambda: np.zeros((len(haps), len(reads)))
    collect = pairhmm.compute_log_likelihoods_async(
        job["r"], job["rl"], job["q"], job["iq"], job["dq"], job["cq"],
        job["h"], job["hl"], device)
    return lambda: collect().reshape(job["H"], job["Ru"])[:, job["col_of"]]


def _bucket(n, step):
    return max(step, ((n + step - 1) // step) * step)


class PairHMMBatcher:
    """Cross-region PairHMM batching: regions submit (read, hap) jobs;
    the batcher pads them to bucketed (R, H) shapes and launches ONE
    device pass per bucket over the concatenated pairs when flushed —
    the device-wide analogue of the reference's global PairHMM task
    queue (PairHMMConcurrentControl.h:38-53, where idle threads co-
    compute any region's queued pair slices). Bucketing (R to 32s, H to
    64s) bounds the number of compiled shapes; padding is free for the
    kernel (dead rows freeze, dead columns are masked from the sum, and
    the in-row scan depth is shape-independent under the cq>=8 cap).

    submit() queues and returns a thunk; the thunk flushes the queue on
    first use, so callers keep the dispatch-early/collect-late pattern.
    `launches`/`regions_submitted` expose the batching ratio, `pairs` and
    `cells` the work sent to the card (pairs and rlen x hlen DP cells)."""

    def __init__(self, device, np_target: int = 8192):
        self.device = device
        self.np_target = np_target
        self._queue = []          # (job, slot) pending
        self._np_pending = 0
        self.launches = 0
        self.regions_submitted = 0
        self.pairs = 0
        self.cells = 0

    def submit(self, reads, haps, pcr_cache=None):
        job = _pairhmm_job(reads, haps, pcr_cache)
        if job is None:
            return lambda: np.zeros((len(haps), len(reads)))
        self.regions_submitted += 1
        slot = {"collect": None, "off": 0}
        self._queue.append((job, slot))
        self._np_pending += job["H"] * job["Ru"]
        if self._np_pending >= self.np_target:
            self.flush()

        def thunk():
            if slot["collect"] is None:
                self.flush()
            flat = slot["collect"]()
            off = slot["off"]
            m = flat[off:off + job["H"] * job["Ru"]]
            return m.reshape(job["H"], job["Ru"])[:, job["col_of"]]
        return thunk

    def flush(self):
        if not self._queue:
            return
        groups = {}
        for job, slot in self._queue:
            key = (_bucket(job["rmax"], 32), _bucket(job["hmax"], 64))
            groups.setdefault(key, []).append((job, slot))
        self._queue = []
        self._np_pending = 0
        for (rb, hb), items in groups.items():
            tot = sum(j["H"] * j["Ru"] for j, _ in items)
            r_arr = np.zeros((tot, rb), np.int32)
            h_arr = np.zeros((tot, hb), np.int32)
            rlens = np.zeros(tot, np.int32)
            hlens = np.zeros(tot, np.int32)
            q = np.zeros((tot, rb), np.int32)
            iq = np.full((tot, rb), DEFAULT_INDEL_QUAL, np.int32)
            dq = np.full((tot, rb), DEFAULT_INDEL_QUAL, np.int32)
            cq = np.full((tot, rb), DEFAULT_GCP, np.int32)
            off = 0
            for job, slot in items:
                n = job["H"] * job["Ru"]
                r_arr[off:off + n, :job["rmax"]] = job["r"]
                h_arr[off:off + n, :job["hmax"]] = job["h"]
                rlens[off:off + n] = job["rl"]
                hlens[off:off + n] = job["hl"]
                q[off:off + n, :job["rmax"]] = job["q"]
                iq[off:off + n, :job["rmax"]] = job["iq"]
                dq[off:off + n, :job["rmax"]] = job["dq"]
                cq[off:off + n, :job["rmax"]] = job["cq"]
                slot["off"] = off
                off += n
            collect = pairhmm.compute_log_likelihoods_async(
                r_arr, rlens, q, iq, dq, cq, h_arr, hlens, self.device)
            self.launches += 1
            self.pairs += tot
            self.cells += int(np.dot(rlens.astype(np.int64), hlens))

            def cached(c=collect, box=[]):
                # one device fetch + f64 fallback pass per LAUNCH, not
                # per region slice
                if not box:
                    box.append(c())
                return box[0]

            for _, slot in items:
                slot["collect"] = cached


def _read_offset_at(rd, pos):
    """Read-coordinate of reference position pos, or None if deleted/
    outside (cigar walk)."""
    rp = rd["pos"]
    qp = 0
    for op, ln in rd["cigar"]:
        if op in (0, 7, 8):       # M/=/X
            if rp <= pos < rp + ln:
                return qp + (pos - rp)
            rp += ln
            qp += ln
        elif op == 1 or op == 4:  # I/S
            qp += ln
        elif op in (2, 3):        # D/N
            if rp <= pos < rp + ln:
                return None
            rp += ln
    return None


def _tandem_repeat_rpa(ref_codes, pos, ref_a, alt_a, window=150):
    """TandemRepeat annotation (RPA/RU/STR) with the reference binary's
    exact semantics (GATKVariantContextUtils.cpp:601-664 + TandemRepeat
    .cpp:15-41). Note: the reference's findRepeatedSubstring compares
    with memcpy instead of memcmp (.cpp:677), so its repeat unit is
    ALWAYS the single first base of the longer allele — reproduced here
    deliberately for oracle concordance. A second reproduced quirk: the
    binary feeds ReferenceCache::getSubsequenceAt the 1-based
    vc->getStart() where the cache expects 0-based, so its "reference
    context after the variant" actually begins TWO bases after the
    anchor (pos+2, not pos+1). Returns (rpa_ref, rpa_alt, unit_str) or
    None when either count is zero (no annotation)."""
    if len(ref_a) == len(alt_a):
        return None
    bases = "ACGTN"
    ref_b = ref_a[1:]
    alt_b = alt_a[1:]
    unit = (alt_b if len(alt_b) > len(ref_b) else ref_b)[0]
    following = "".join(bases[b] for b in
                        ref_codes[pos + 2:pos + 2 + window +
                                  len(ref_a) - 1])

    def leading(s):
        n = 0
        while n < len(s) and s[n] == unit:
            n += 1
        return n

    reps_in_ref = leading(ref_b)
    c_ref = leading(ref_b + following) - reps_in_ref
    c_alt = leading(alt_b + following) - reps_in_ref
    if c_ref == 0 or c_alt == 0:
        return None
    return c_ref, c_alt, unit


def _median_ref(values, default):
    """MathUtils::median (MathUtils.cpp:185-193): sorted middle; for even
    sizes the rounded mean of the two middles (round half away)."""
    if not values:
        return default
    v = sorted(values)
    n = len(v)
    if n % 2:
        return int(v[n // 2])
    return int(np.floor((v[(n - 1) // 2] + v[n // 2]) / 2.0 + 0.5))


def _read_end(rd):
    """1-past-last reference position consumed by the alignment."""
    return rd["pos"] + sum(ln for op, ln in rd["cigar"]
                           if op in (0, 2, 3, 7, 8))


ANNOT_MIN_BQ = 20  # OrientationBiasReadCounts.h MINIMUM_BASE_QUALITY


def _sample_fmt(reads, m, pos):
    """Per-sample genotype column (addGenotypes + the genotype annotators
    DepthPerAlleleBySample / DepthPerSampleHC / OrientationBiasReadCounts /
    StrandBiasBySample), over the overlap-kept reads of that sample.
    m: [2, R] natural-log allele likelihoods (row 0 = ref)."""
    best_alt, informative = genotype.best_alleles(m)
    ad_ref = int((informative & ~best_alt).sum())
    ad_alt = int((informative & best_alt).sum())
    af = genotype.allele_fraction_posterior_mean(m)
    f1r2 = [0, 0]
    f2r1 = [0, 0]
    sb = [0, 0, 0, 0]
    for i, rd in enumerate(reads):
        if not informative[i]:
            continue
        a = 1 if best_alt[i] else 0
        rev = bool(rd.get("is_reverse", False))
        sb[2 * a + (1 if rev else 0)] += 1
        mq = rd.get("mapq", 60)
        if mq in (0, 255):
            continue
        off = _read_offset_at(rd, pos)
        bq = int(rd["quals"][off]) if off is not None else 0
        if bq >= ANNOT_MIN_BQ:
            # ReadUtils::isF2R1: reverse-strand == first-of-pair
            is_f2r1 = rev == bool(rd.get("is_first_of_pair", False))
            (f2r1 if is_f2r1 else f1r2)[a] += 1
    return dict(ad=(ad_ref, ad_alt), dp=ad_ref + ad_alt, af=af,
                f1r2=tuple(f1r2), f2r1=tuple(f2r1), sb=tuple(sb))


def _annotate_event(pos, ref_a, alt_a, tm, nm, t_reads, n_reads):
    """The annotator battery for one event (VariantAnnotatorEngine over
    the read likelihoods marginalized to the variant interval expanded by
    ALLELE_EXTENSION=2, SomaticGenotypeEngine.cpp:148-165):

      INFO : DP (Coverage), MBQ (BaseQuality), MMQ (MappingQuality),
             MPOS (ReadPosition), MFRL (FragmentLength) — per-allele
             medians over informative reads of BOTH samples
      FORMAT: AD/DP (DepthPerAlleleBySample, DepthPerSampleHC),
             AF (addGenotypes posterior), F1R2/F2R1
             (OrientationBiasReadCounts), SB (StrandBiasBySample)

    tm/nm: [2, R] natural-log allele likelihoods per sample (nm None
    without a normal); t_reads/n_reads: the realigned read dicts."""
    vc_end = pos + len(ref_a) - 1
    a0, a1 = pos - 2, vc_end + 2

    def kept(reads):
        return [i for i, rd in enumerate(reads)
                if rd["pos"] <= a1 and _read_end(rd) - 1 >= a0]

    ti = kept(t_reads)
    t_m = tm[:, ti]
    t_rd = [t_reads[i] for i in ti]
    if nm is not None:
        ni = kept(n_reads)
        n_m = nm[:, ni]
        n_rd = [n_reads[i] for i in ni]
    else:
        n_m, n_rd = None, []
    comb_m = np.concatenate([t_m, n_m], axis=1) if n_m is not None else t_m
    comb_rd = t_rd + n_rd

    best_alt, informative = genotype.best_alleles(comb_m)
    vals = {k: ([], []) for k in ("bq", "mq", "mpos", "frl")}
    for i, rd in enumerate(comb_rd):
        if not informative[i]:
            continue
        mq = rd.get("mapq", 60)
        if mq in (0, 255):
            continue
        a = 1 if best_alt[i] else 0
        vals["mq"][a].append(int(mq))
        vals["frl"][a].append(abs(int(rd.get("frag_len", 0) or 0)))
        if rd["pos"] <= pos <= _read_end(rd) - 1:
            off = _read_offset_at(rd, pos)
            if off is not None:
                vals["bq"][a].append(int(rd["quals"][off]))
                # ReadPosRankSumTest.cpp:27-37: distance from the nearer
                # end of the ORIGINAL read (hard-clipped bases count)
                L = int(rd.get("orig_len", len(rd["seq_codes"])))
                p = int(rd.get("lclip", 0)) + off
                if p > L // 2:
                    p = L - p - 1
                vals["mpos"][a].append(p)
    mbq = (_median_ref(vals["bq"][0], 0), _median_ref(vals["bq"][1], 0))
    mmq = (_median_ref(vals["mq"][0], 60), _median_ref(vals["mq"][1], 60))
    mpos = _median_ref(vals["mpos"][1], 50)
    mfrl = (_median_ref(vals["frl"][0], 0), _median_ref(vals["frl"][1], 0))
    t_fmt = _sample_fmt(t_rd, t_m, pos)
    n_fmt = _sample_fmt(n_rd, n_m, pos) if n_m is not None else None
    return dict(depth=comb_m.shape[1], mbq_ref=mbq[0], mbq_alt=mbq[1],
                mmq_ref=mmq[0], mmq_alt=mmq[1], mpos=mpos, mfrl=mfrl,
                mfrl_diff=float(abs(mfrl[1] - mfrl[0])),
                ad_ref=t_fmt["ad"][0], ad_alt=t_fmt["ad"][1],
                af=t_fmt["af"], sb=t_fmt["sb"],
                normal_ad_ref=n_fmt["ad"][0] if n_fmt else 0,
                normal_ad_alt=n_fmt["ad"][1] if n_fmt else 0,
                tumor_fmt=t_fmt, normal_fmt=n_fmt)


def _prepare_region_impl(ref, cfg, gate, reg, t_reads, n_reads):
    """Pure-host region prep (assembly + trim + the gate's features):
    module-level so the region pool's workers can run it (the
    reference's N-thread region scheduler, main.cpp:195-307 — assembly
    is pure Python and the caller's Amdahl wall without it). With
    `gate`, a region of more than 100 tumor reads carries the CNN gate's
    inputs; the engine classifies them on its device before dispatch."""
    span = (reg.padded_start, reg.padded_end)
    ref_seg = ref[span[0]:span[1]].astype(np.uint8)
    if not t_reads:
        return None
    for rd in t_reads:
        rd.setdefault("sample", "tumor")
    for rd in n_reads:
        rd.setdefault("sample", "normal")
    haps = assembly.assemble_region(ref_seg, t_reads + n_reads,
                                    kmer_sizes=cfg.kmer_sizes)
    if len(haps) <= 1:
        return None
    hap_bases = [h.bases for h in haps]
    # one hap->ref alignment per haplotype, shared by event
    # extraction and read realignment
    hap_cigars = [None if h.is_ref else
                  genotype.haplotype_cigar(h.bases, ref_seg)
                  for h in haps]
    hap_events = [[] if h.is_ref else
                  genotype.haplotype_events(h.bases, ref_seg, span[0],
                                            cigar=hap_cigars[i])
                  for i, h in enumerate(haps)]
    all_events = {}
    for evs in hap_events:
        for e in evs:
            if reg.start <= e.pos < reg.end:
                all_events[(e.pos, e.ref, e.alt)] = e
    if not all_events:
        return None

    # AssemblyRegionTrimmer (AssemblyRegionTrimmer.cpp:31-84,
    # Mutect2Engine.cpp:190-199): shrink the region to the variation
    # span + padding, trim haplotypes and hard-clip reads to it
    from . import trimming
    flat_events = [(e.pos, e.ref, e.alt)
                   for evs in hap_events for e in evs]
    tr = trimming.trimmed_span(reg.start, reg.end, flat_events,
                               len(ref))
    if tr is None:
        return None
    w0 = max(tr[0], span[0])
    w1 = min(tr[1], span[1])
    hap_roff = [span[0]] * len(haps)
    if (w0, w1) != span and w0 < w1:
        new_ref_seg = ref[w0:w1].astype(np.uint8)
        new_bases, new_cigars, hap_roff = [], [], []
        for i, h in enumerate(haps):
            if h.is_ref or hap_cigars[i] is None:
                new_bases.append(new_ref_seg)
                new_cigars.append(None)
                hap_roff.append(w0)
                continue
            out = trimming.clip_to_window(hap_bases[i], None,
                                          hap_cigars[i], span[0],
                                          w0, w1)
            if out is None:        # no aligned hap base in window
                new_bases.append(new_ref_seg)
                new_cigars.append(None)
                hap_roff.append(w0)
                continue
            b2, _, p2, c2 = out
            new_bases.append(b2)
            new_cigars.append(c2)
            hap_roff.append(p2)
        hap_bases, hap_cigars = new_bases, new_cigars
        ref_seg = new_ref_seg
        span = (w0, w1)
        t_reads = [r2 for r in t_reads
                   if (r2 := trimming.clip_read_to_window(r, w0, w1))
                   is not None]
        n_reads = [r2 for r in n_reads
                   if (r2 := trimming.clip_read_to_window(r, w0, w1))
                   is not None]
        if not t_reads:
            return None

    # CNN gate ("deep" mode): dense regions where NO candidate variant
    # classifies as somatic are skipped wholesale
    # (Mutect2Engine.cpp:213-221: `if (!mymodel.modelRefer(...))
    # return {}` — modelRefer TRUE means keep)
    gate_in = None
    if gate and len(t_reads) > 100:
        from .cnn_filter import gate_inputs
        gate_in = gate_inputs(ref, t_reads, n_reads,
                              [pos for (pos, _, _) in all_events])[0]
    return dict(reg=reg, span=span, ref_seg=ref_seg, t_reads=t_reads,
                n_reads=n_reads, haps=haps, hap_bases=hap_bases,
                hap_events=hap_events, all_events=all_events,
                hap_cigars=hap_cigars, hap_roff=hap_roff,
                gate_inputs=gate_in)


_REGION_CTX = {}


def _region_worker_init(ref, cfg, contig="", emission=None,
                        normal_odds=None, gate=False):
    _REGION_CTX["gate"] = gate
    _REGION_CTX["ref"] = ref
    _REGION_CTX["cfg"] = cfg
    _REGION_CTX["contig"] = contig
    _REGION_CTX["emission"] = emission
    _REGION_CTX["normal_odds"] = normal_odds


def _region_worker_prepare(reg, t_reads, n_reads):
    return _prepare_region_impl(_REGION_CTX["ref"], _REGION_CTX["cfg"],
                                _REGION_CTX["gate"], reg, t_reads,
                                n_reads)


def _region_worker_finish(args):
    prep, t_lik, n_lik = args
    return _finish_region_impl(_REGION_CTX["ref"], _REGION_CTX["contig"],
                               _REGION_CTX["emission"],
                               _REGION_CTX["normal_odds"], prep,
                               t_lik, n_lik)


class Mutect2Engine:
    """One contig's caller. `device` is where the PairHMM and the CNN
    gate's forward run: the CUDA card by default (raises without one),
    the CPU only when asked. `cnn_model_path` turns the gate on."""

    def __init__(self, ref_codes, contig_name, cfg: CallConfig | None = None,
                 emission_log10_odds=DEFAULT_EMISSION_LOG10_ODDS,
                 normal_log10_odds=DEFAULT_NORMAL_LOG10_ODDS,
                 cnn_model_path=None, region_workers: int = 0,
                 device=None):
        from ..utils.device import resolve_device
        self.device = resolve_device(device)
        self.cnn = None
        if cnn_model_path:
            from .cnn_filter import CnnFilter
            self.cnn = CnnFilter(cnn_model_path, self.device)
        self.gated_regions = 0      # regions the gate classified
        self.gate_dropped = 0       # ... and dropped
        self.ref = np.asarray(ref_codes, np.uint8)
        self.contig = contig_name
        self.cfg = cfg or CallConfig()
        self.emission = emission_log10_odds
        self.normal_odds = normal_log10_odds
        from .pcr_model import pcr_indel_cache
        self._pcr_cache = pcr_indel_cache(self.cfg.pcr_error_model)
        # host-side region worker pool (the reference's N-thread region
        # scheduler, main.cpp:195-307): assembly/trim are pure Python —
        # fan them out while the main process runs activity profiling
        # and drives the card's PairHMM pipeline
        self.region_workers = region_workers
        self._region_pool = None
        # cross-region PairHMM batching (PairHMMConcurrentControl.h
        # analogue)
        self._hmm_batcher = PairHMMBatcher(self.device)

    def _get_region_pool(self):
        if self._region_pool is None and self.region_workers > 0:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            self._region_pool = ProcessPoolExecutor(
                self.region_workers,
                mp_context=mp.get_context("spawn"),
                initializer=_region_worker_init,
                initargs=(self.ref, self.cfg, self.contig, self.emission,
                          self.normal_odds, self.cnn is not None))
        return self._region_pool

    def close(self):
        if self._region_pool is not None:
            self._region_pool.shutdown()
            self._region_pool = None


    def call(self, tumor_reads, normal_reads=()):
        """tumor_reads/normal_reads: list of dicts (pos, cigar, seq_codes,
        quals, mate_start, properly_paired). Returns list[VariantCall].
        Also accumulates self.callable_sites (tumor depth >= 10), the
        count FilterMutectCalls' clustering model uses to learn empirical
        variant priors (SomaticClusteringModel.cpp:241-247)."""
        cfg = self.cfg
        n = len(self.ref)
        t_index = _ReadIndex(tumor_reads)
        n_index = _ReadIndex(normal_reads)

        def windows():
            for rstart in range(0, n, cfg.region_size):
                yield (rstart, min(rstart + cfg.region_size, n),
                       t_index, n_index)

        return self.call_windows(windows())

    def call_windows(self, windows):
        """Streaming form of call(): windows yields (rstart, rend,
        t_index, n_index) where the _ReadIndex objects cover at least
        [rstart - padding, rend + padding). This is the engine half of
        the reference's ReadCache region loop (main.cpp:254-307) — the
        source decides how reads materialize (whole-contig in-memory or
        BAI-windowed from disk, call/readcache.py)."""
        cfg = self.cfg
        n = len(self.ref)
        self.callable_sites = 0
        self.n_regions = 0          # active assembly regions processed
        calls = []

        # pipelined regions: dispatch region i's PairHMM, assemble the
        # following regions on host while the device crunches; finish in
        # order. Depth > 1 keeps several small regions in flight (the
        # reference's device-wide PairHMM batching analogue).
        import collections
        # a deep pipeline under cross-region batching: more regions in
        # flight -> more jobs per flushed launch
        DEPTH = 6
        pending = collections.deque()
        pool = self._get_region_pool()
        prep_q = collections.deque()
        fin_q = collections.deque()
        AHEAD = max(2 * self.region_workers, 1)

        def retire(prep, futs):
            # pooled: the main thread only RESOLVES the device matrices;
            # genotyping/annotation fan out to the workers (the
            # reference's division of labor — threads do region work,
            # the shared queues carry PairHMM, main.cpp:367-423).
            if pool is None:
                calls.extend(self._finish_region(prep, futs))
                return
            t_fut, n_fut = futs
            t_lik = t_fut()
            n_lik = n_fut() if n_fut is not None else None
            fin_q.append(pool.submit(_region_worker_finish,
                                     (prep, t_lik, n_lik)))
            while fin_q and fin_q[0].done():
                calls.extend(fin_q.popleft().result())

        def drain(force):
            while prep_q and (force or len(prep_q) > AHEAD
                              or prep_q[0].done()):
                prep = self._gate(prep_q.popleft().result())
                if prep is not None:
                    pending.append((prep, self._dispatch_region(prep)))
                while len(pending) >= DEPTH:
                    retire(*pending.popleft())

        for rstart, rend, t_index, n_index in windows:
            t_reads = t_index.span(rstart, rend)
            if not t_reads:
                continue
            n_reads = n_index.span(rstart, rend)
            tp = activity.build_pileup(t_reads, rstart, rend, self.ref, 0,
                                       cfg.pcr_error_qual)
            self.callable_sites += int(
                (tp.depth >= self.cfg.callable_depth).sum())
            np_ = activity.build_pileup(n_reads, rstart, rend, self.ref, 0,
                                        cfg.pcr_error_qual) \
                if n_reads else None
            probs = activity.activity_probs(tp, normal_pileup=np_)
            smooth = activity.band_pass_smooth(probs)
            regions = activity.pop_assembly_regions(
                smooth, rstart, cfg.min_assembly_region_size,
                cfg.max_assembly_region_size, cfg.assembly_region_padding,
                contig_len=n)
            for reg in regions:
                if not reg.is_active:
                    continue
                self.n_regions += 1
                if pool is not None:
                    span = (reg.padded_start, reg.padded_end)
                    prep_q.append(pool.submit(
                        _region_worker_prepare, reg,
                        t_index.span(*span), n_index.span(*span)))
                    drain(False)
                    continue
                prep = self._gate(self._prepare_region(reg, t_index,
                                                       n_index))
                if prep is not None:
                    pending.append((prep, self._dispatch_region(prep)))
                while len(pending) >= DEPTH:
                    retire(*pending.popleft())
        drain(True)
        while pending:
            retire(*pending.popleft())
        while fin_q:
            calls.extend(fin_q.popleft().result())
        calls.sort(key=lambda c: c.pos)
        return calls

    def _prepare_region(self, reg, t_index, n_index):
        """Host stage: reads, assembly, events, the gate's features.
        Returns the region context dict or None when nothing to call."""
        span = (reg.padded_start, reg.padded_end)
        t_reads = t_index.span(*span)
        n_reads = n_index.span(*span)
        return _prepare_region_impl(self.ref, self.cfg,
                                    self.cnn is not None, reg, t_reads,
                                    n_reads)

    def _gate(self, prep):
        """The CNN gate's decision on a prepared region, one forward on
        the engine's device: the region, or None when the gate drops
        it."""
        if prep is None or prep["gate_inputs"] is None:
            return prep
        self.gated_regions += 1
        if self.cnn.keep(prep.pop("gate_inputs")):
            return prep
        self.gate_dropped += 1
        return None


    def _dispatch_region(self, prep):
        """Device stage: async PairHMM dispatch for both samples, queued
        into the cross-region batcher (tumor and normal jobs of several
        regions ride one bucketed launch)."""
        sub = self._hmm_batcher.submit
        t_fut = sub(prep["t_reads"], prep["hap_bases"], self._pcr_cache)
        n_fut = sub(prep["n_reads"], prep["hap_bases"],
                    self._pcr_cache) if prep["n_reads"] else None
        return t_fut, n_fut

    def _finish_region(self, prep, futs):
        t_fut, n_fut = futs
        t_lik = t_fut()                               # [H, Rt] log10
        n_lik = n_fut() if n_fut is not None else None
        return _finish_region_impl(self.ref, self.contig, self.emission,
                                   self.normal_odds, prep, t_lik, n_lik)


def _finish_region_impl(ref, contig, emission, normal_odds, prep,
                        t_lik, n_lik):
    """Genotyping half of callRegion given the PairHMM matrices:
    likelihood post-processing, realignment, somatic log-odds,
    annotation, phasing (Mutect2Engine.cpp:223-246 semantics).
    Module-level so region workers can run it — with the pool, the
    main thread only drives the device (the reference's division of
    labor, main.cpp:367-423)."""
    if True:
        span = prep["span"]
        ref_seg = prep["ref_seg"]
        reg = prep["reg"]
        t_reads = prep["t_reads"]
        n_reads = prep["n_reads"]
        haps = prep["haps"]
        hap_bases = prep["hap_bases"]
        hap_events = prep["hap_events"]
        all_events = prep["all_events"]

        # PairHMMLikelihoodCalculationEngine.cpp:93-94 post-processing:
        #  1. normalizeLikelihoods(qualToErrorProbLog10(45)): every
        #     haplotype likelihood is floored at best - 4.5 log10 (the
        #     global read-mismapping rate cap), and
        #  2. filterPoorlyModeledEvidence: drop reads whose best
        #     likelihood < -4.0 * min(2, ceil(0.02 * len)) — reads no
        #     haplotype explains (log10MinTrueLikelihood, .cpp:294-299)
        def norm_filter(lik, reads):
            if lik is None or not len(reads):
                return lik, reads
            best = lik.max(axis=0)
            lik = np.maximum(lik, best[None, :] - 4.5)
            min_true = np.array([-4.0 * min(2.0, np.ceil(
                len(r["seq_codes"]) * 0.02)) for r in reads])
            keep = best >= min_true
            if keep.all():
                return lik, reads
            return lik[:, keep], [r for r, k in zip(reads, keep) if k]

        t_lik, t_reads = norm_filter(t_lik, t_reads)
        n_lik, n_reads = norm_filter(n_lik, n_reads)
        if t_lik is None or t_lik.shape[1] == 0:
            return []

        # realignReadsToTheirBestHaplotype (AssemblyBasedCallerUtils
        # .cpp:163): annotation pileups (MBQ/MPOS) see indel-aware
        # coordinates. Reads whose best haplotype is the reference keep
        # their aligner coordinates (they already match the ref).
        from . import realign as realignmod
        hap_cigars = prep["hap_cigars"]

        def realign_all(reads, lik):
            if not reads:
                return []
            best_h = np.argmax(lik, axis=0)
            out = []
            for r_i, rd in enumerate(reads):
                h = int(best_h[r_i])
                if haps[h].is_ref or hap_cigars[h] is None:
                    out.append(rd)
                    continue
                try:
                    new_pos, new_cig = realignmod.realign_read(
                        rd["seq_codes"], hap_bases[h], hap_cigars[h],
                        prep["hap_roff"][h])
                    rd2 = dict(rd)
                    rd2["pos"] = new_pos
                    rd2["cigar"] = new_cig
                    out.append(rd2)
                except Exception:  # noqa: BLE001 - annotation fallback
                    out.append(rd)
            return out

        ann_reads = realign_all(t_reads, t_lik)
        n_ann_reads = realign_all(n_reads, n_lik) \
            if n_lik is not None else []

        calls = []
        call_hapsets = []
        site_lods = {}
        for (pos, ref_a, alt_a), ev in sorted(all_events.items()):
            has_alt = np.array([any(e.pos == pos and e.ref == ref_a and
                                    e.alt == alt_a for e in evs)
                                for evs in hap_events])
            spans = np.ones(len(haps), bool)
            tm = genotype.marginalize_to_alleles(t_lik, has_alt, spans)
            tlod_ln = genotype.somatic_log_odds(tm)[0]
            tlod = tlod_ln / LOG10
            if tlod <= emission:
                continue
            nlod = None
            n_art_lod = None
            nm = None
            if n_lik is not None and n_lik.shape[1] > 0:
                nm = genotype.marginalize_to_alleles(n_lik, has_alt, spans)
                # NLOD: diploid hom-ref over het odds in the normal
                # (SomaticGenotypeEngine::diploidAltLogOdds)
                nlod = float(genotype.diploid_alt_log_odds(nm)) / LOG10
                # NALOD: negated somatic odds of the allele in the normal
                # (NORMAL_ARTIFACT_LOG_10_ODDS_KEY, .cpp:126-128)
                n_art_lod = -float(genotype.somatic_log_odds(nm)[0]) / LOG10
                # germline-allele gate (.cpp:94-105): when the normal
                # does NOT look hom-ref, skip the variant entirely
                if nlod <= normal_odds:
                    continue
            ann = _annotate_event(pos, ref_a, alt_a, tm, nm,
                                  ann_reads, n_ann_reads)
            tr = _tandem_repeat_rpa(ref, pos, ref_a, alt_a)
            site_lods.setdefault(pos, []).append(float(tlod))
            calls.append(VariantCall(
                contig=contig, pos=pos, ref=ref_a, alt=alt_a,
                tlod=float(tlod), nlod=nlod,
                filters=(),
                n_artifact_lod=n_art_lod,
                rpa=(tr[0], tr[1]) if tr else None,
                repeat_unit=tr[2] if tr else "",
                repeat_unit_length=len(tr[2]) if tr else 0,
                repeat_count=tr[0] if tr else 0,
                n_count=_count_ns_at(t_reads, n_reads, pos),
                **ann))
            call_hapsets.append(frozenset(np.flatnonzero(has_alt)))
        for c in calls:
            c.site_alt_lods = tuple(site_lods.get(c.pos, ()))
            # ECNT = emitted calls in this region (SomaticGenotypeEngine
            # .cpp:182-189: outputCalls->size(), not assembled events)
            c.ecnt = len(calls)
        _assign_phasing(calls, call_hapsets)
        return calls


def _count_ns_at(t_reads, n_reads, pos):
    """CountNs annotation (N_COUNT_KEY, consumed by NRatioFilter):
    reads of either sample whose base at the site is N."""
    n = 0
    for rd in t_reads + list(n_reads):
        off = _read_offset_at(rd, pos)
        if off is not None and int(rd["seq_codes"][off]) == 4:
            n += 1
    return n


def _assign_phasing(calls, call_hapsets):
    """Region-local phasing (AssemblyBasedCallerUtils phaseCalls,
    simplified): calls supported by the identical non-empty haplotype
    subset are one phase group; the group's PID is the GATK-style
    '<pos1>_<ref>_<alt>' of its first variant, PGT is 0|1. The
    complementary-set ('1|0') case of the reference is not detected —
    same-set groups are what FilteredHaplotypeFilter consumes."""
    groups = {}
    for c, hs in zip(calls, call_hapsets):
        if hs:
            groups.setdefault(hs, []).append(c)
    for hs, members in groups.items():
        if len(members) < 2:
            continue
        first = min(members, key=lambda c: c.pos)
        pid = f"{first.pos + 1}_{first.ref}_{first.alt}"
        for c in members:
            c.phasing = ("0|1", pid)


def apply_filter_mutect_calls(calls, **overrides):
    """FilterMutectCalls over engine output: 2 learning passes + apply
    (reference main.cpp:643-662). Mutates call.filters; returns the
    filtering engine (for stats)."""
    from . import filtering as fl

    fcs = [fl.FilterableCall(
        tlod=c.tlod, ad_ref=c.ad_ref, ad_alt=c.ad_alt,
        indel_length=len(c.alt) - len(c.ref), af=c.af, sb=c.sb,
        mbq_ref=c.mbq_ref, mbq_alt=c.mbq_alt, mmq_alt=c.mmq_alt,
        mpos=c.mpos, mfrl_diff=c.mfrl_diff, ecnt=c.ecnt,
        site_alt_lods=c.site_alt_lods, pop_af=c.pop_af, nlod=c.nlod,
        n_artifact_lod=c.n_artifact_lod, normal_ad_ref=c.normal_ad_ref,
        normal_ad_alt=c.normal_ad_alt,
        repeat_unit_length=c.repeat_unit_length,
        repeat_count=c.repeat_count, rpa=c.rpa,
        pos=c.pos, n_count=c.n_count, in_pon=c.in_pon,
        phasing="".join(c.phasing) if c.phasing else None)
        for c in calls]
    eng = fl.filter_calls(fcs, **overrides)
    for c, fc in zip(calls, fcs):
        c.filters = tuple(fc.filters)
    return eng


def _g6(x):
    """htslib-style %g float (how the reference's VCFWriter/bcf prints)."""
    return f"{float(x):.6g}"


def write_vcf(path, calls, contig_names, contig_lens,
              tumor_sample="tumor", normal_sample=None):
    """VCF output matching the reference VCFWriter.cpp record shape:
    INFO keys in alphabetical order (DP,ECNT,MBQ,MFRL,MMQ,MPOS,NALOD,
    NLOD,POPAF,[RPA,RU,STR,]TLOD), FORMAT GT:AD:DP:AF:F1R2:F2R1:SB with
    GT omitted ('.'), sample columns normal-first (merged-header
    order, input_bam[0] = normal after adjust_input_bam)."""
    from ..io.vcf import VcfWriter
    samples = ([normal_sample] if normal_sample else []) + [tumor_sample]
    w = VcfWriter(path, contig_names, contig_lens, samples)
    for c in calls:
        info = {"DP": c.depth, "ECNT": c.ecnt,
                "MBQ": f"{c.mbq_ref},{c.mbq_alt}",
                "MFRL": f"{c.mfrl[0]},{c.mfrl[1]}",
                "MMQ": f"{c.mmq_ref},{c.mmq_alt}",
                "MPOS": c.mpos}
        if c.n_artifact_lod is not None:
            info["NALOD"] = _g6(c.n_artifact_lod)
        if c.n_count:
            info["NCount"] = c.n_count
        if c.nlod is not None:
            info["NLOD"] = _g6(c.nlod)
        if c.in_pon:
            info["PON"] = True
        info["POPAF"] = _g6(-np.log10(max(c.pop_af, 1e-10)))
        if c.rpa is not None:
            info["RPA"] = f"{c.rpa[0]},{c.rpa[1]}"
            info["RU"] = c.repeat_unit
            info["STR"] = True
        info["TLOD"] = _g6(c.tlod)

        def col(fmt):
            if fmt is None:
                return {"GT": "."}
            d = {"GT": ".",
                 "AD": f"{fmt['ad'][0]},{fmt['ad'][1]}",
                 "DP": str(fmt["dp"]),
                 "AF": _g6(fmt["af"]),
                 "F1R2": f"{fmt['f1r2'][0]},{fmt['f1r2'][1]}",
                 "F2R1": f"{fmt['f2r1'][0]},{fmt['f2r1'][1]}",
                 "SB": ",".join(str(x) for x in fmt["sb"])}
            return d

        t_col = col(c.tumor_fmt or
                    dict(ad=(c.ad_ref, c.ad_alt), dp=c.ad_ref + c.ad_alt,
                         af=c.af, f1r2=(0, 0), f2r1=(0, 0), sb=c.sb))
        if c.phasing:
            t_col["PGT"], t_col["PID"] = c.phasing
        fields = ([col(c.normal_fmt)] if normal_sample else []) + [t_col]
        w.add(c.contig, c.pos + 1, c.ref, [c.alt], info, list(c.filters),
              fields)
    w.close()
