"""ApplyBQSR: base-quality recalibration from a GATK recal table.

Port of the reference's --bqsr-within-mutect transformer (deepmutect
Mutect2Cpp-master/src/transformers/BQSRReadTransformer.cpp and
transformers/recalibration/): parse the GATKReport recal tables, compute
context/cycle covariate keys per base, and recalibrate via the
hierarchical Bayesian delta stack (hierarchicalBayesianQualityEstimate,
BQSRReadTransformer.cpp:105-130) with quantized output quals.

Host code, copied from the JAX package's call/bqsr.py: the port applies
it per read as the JAX package does (call/readcache.StreamingReadSource
per window, cli.cmd_mutect's whole-BAM path per read).
"""

from __future__ import annotations

import math

import numpy as np

# RecalDatum.h:17-67, RecalDatum.cpp:56-63
RESOLUTION_BINS_PER_QUAL = 1.0
MAX_GATK_USABLE_Q_SCORE = 40
MAX_REASONABLE_Q_SCORE = 60
MAX_RECALIBRATION_Q_SCORE = 93
MAX_NUMBER_OF_OBSERVATIONS = 2 ** 31 - 1
GF_A, GF_B, GF_C = 0.9, 0.0, 0.5

# covariate defaults (RecalibrationArgumentCollection)
MISMATCHES_CONTEXT_SIZE = 2
MAXIMUM_CYCLE_VALUE = 500
LOW_QUAL_TAIL = 2
PRESERVE_QSCORES_LESS_THAN = 6
LENGTH_BITS = 4

_PRIOR_CACHE = None


def _log10_qemp_prior(q_emp: float, q_reported: float) -> float:
    global _PRIOR_CACHE
    if _PRIOR_CACHE is None:
        temp = 2 * GF_C * GF_C
        _PRIOR_CACHE = []
        for i in range(MAX_GATK_USABLE_Q_SCORE + 1):
            v = GF_A * math.exp(-((i - GF_B) ** 2) / temp)
            _PRIOR_CACHE.append(math.log10(v) if v > 0 else -1e308)
    diff = min(abs(int(q_emp - q_reported)), MAX_GATK_USABLE_Q_SCORE)
    return _PRIOR_CACHE[diff]


def _log10_binomial(n: int, k: int, log10p: float) -> float:
    p = 10.0 ** log10p
    p = min(max(p, 1e-300), 1 - 1e-15)
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1)) / math.log(10) \
        + k * log10p + (n - k) * math.log10(1 - p)


def bayesian_empirical_quality(n_obs: int, n_err: int,
                               q_reported: float) -> float:
    """RecalDatum::bayesianEstimateOfEmpiricalQuality."""
    if n_obs > MAX_NUMBER_OF_OBSERVATIONS:
        frac = MAX_NUMBER_OF_OBSERVATIONS / n_obs
        n_err = round(n_err * frac)
        n_obs = MAX_NUMBER_OF_OBSERVATIONS
    num_bins = int((MAX_REASONABLE_Q_SCORE + 1) * RESOLUTION_BINS_PER_QUAL)
    best_bin, best = 0, -math.inf
    for i in range(num_bins):
        q = i / RESOLUTION_BINS_PER_QUAL
        ll = 0.0 if n_obs == 0 else _log10_binomial(n_obs, n_err, q / -10.0)
        post = _log10_qemp_prior(q, q_reported) + ll
        if post > best:
            best_bin, best = i, post
    return best_bin / RESOLUTION_BINS_PER_QUAL


class RecalDatum:
    """Observations/errors cell with lazily-computed empirical quality."""

    __slots__ = ("n_obs", "n_err", "reported", "_emp")

    def __init__(self, n_obs, n_err, reported):
        self.n_obs = int(n_obs)
        self.n_err = float(n_err)
        self.reported = float(reported)
        self._emp = None

    @property
    def estimated_q_reported(self):
        return self.reported

    def empirical_quality(self, conditional_prior: float) -> float:
        if self._emp is None:
            q = bayesian_empirical_quality(self.n_obs, int(round(self.n_err)),
                                           conditional_prior)
            self._emp = min(q, float(MAX_RECALIBRATION_Q_SCORE))
        return self._emp


# --------------------------------------------------------------------------
# covariate keys
# --------------------------------------------------------------------------

def key_from_context(codes, start: int, end: int) -> int:
    """ContextCovariate::keyFromContext — low 4 bits = length, then 2
    bits/base; -1 if any ambiguous base."""
    key = end - start
    offset = LENGTH_BITS
    for i in range(start, end):
        b = int(codes[i])
        if b < 0 or b > 3:
            return -1
        key |= b << offset
        offset += 2
    return key


def key_from_cycle(cycle: int) -> int:
    """CycleCovariate::keyFromCycle."""
    result = abs(cycle)
    if result > MAXIMUM_CYCLE_VALUE:
        raise ValueError("cycle exceeds MAXIMUM_CYCLE_VALUE")
    result <<= 1
    if cycle < 0:
        result += 1
    return result


def context_keys(codes, quals, is_reverse: bool,
                 context_size: int = MISMATCHES_CONTEXT_SIZE) -> np.ndarray:
    """Per-base context keys (ContextCovariate::recordValues): bases are
    low-qual-tail clipped, reverse-complemented on the negative strand,
    and the key at output offset follows the sequencing direction."""
    L = len(codes)
    work = np.asarray(codes, np.int64).copy()
    # hard-clip low-qual ends (ReadClipper.hardClipLowQualEnds(2)):
    # clipped bases become ambiguous for context purposes
    q = np.asarray(quals, np.int64)
    lo = 0
    while lo < L and q[lo] <= LOW_QUAL_TAIL:
        lo += 1
    hi = L
    while hi > lo and q[hi - 1] <= LOW_QUAL_TAIL:
        hi -= 1
    work[:lo] = 4
    work[hi:] = 4
    if is_reverse:
        work = np.where(work < 4, 3 - work[::-1], work[::-1])
    keys = np.full(L, -1, np.int64)
    for i in range(context_size - 1, L):
        keys[i] = key_from_context(work, i - context_size + 1, i + 1)
    out = np.full(L, -1, np.int64)
    for i in range(L):
        off = L - i - 1 if is_reverse else i
        out[off] = keys[i]
    return out


def cycle_keys(L: int, is_reverse: bool, is_second_of_pair: bool,
               paired: bool) -> np.ndarray:
    """Per-base cycle keys (CycleCovariate::recordValues)."""
    order = -1 if (paired and is_second_of_pair) else 1
    if is_reverse:
        cycle = L * order
        inc = -order
    else:
        cycle = order
        inc = order
    out = np.zeros(L, np.int64)
    for i in range(L):
        out[i] = key_from_cycle(cycle)
        cycle += inc
    return out


# --------------------------------------------------------------------------
# GATKReport parsing
# --------------------------------------------------------------------------

def parse_gatk_report(path_or_text: str):
    """Parse a GATKReport (recal table) into {table_name: list[dict]}."""
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    # Format per GATKReport.cpp: for each table, a dimensions line
    # "#:GATKTable:ncols:nrows:fmt:..." then a name line
    # "#:GATKTable:Name:Description", then the header row, data rows,
    # and a blank separator.
    tables = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("#:GATKTable:") and len(ln.split(":")) > 3 and \
                ln.split(":")[2].isdigit():
            i += 1
            name = lines[i].split(":")[2]
            i += 1
            header = lines[i].split()
            rows = []
            i += 1
            while i < len(lines) and lines[i].strip() and \
                    not lines[i].startswith("#:"):
                rows.append(dict(zip(header, lines[i].split())))
                i += 1
            tables[name] = rows
        else:
            i += 1
    return tables


_B2C = {"A": 0, "C": 1, "G": 2, "T": 3}


class BQSRReadTransformer:
    """Apply-BQSR over read dicts (pos/cigar/seq_codes/quals/...)."""

    def __init__(self, recal_path_or_text: str,
                 preserve_q_less_than: int = PRESERVE_QSCORES_LESS_THAN,
                 global_q_score_prior: float = -1.0,
                 quantization_levels: int = 0):
        tables = parse_gatk_report(recal_path_or_text)
        self.rg_table = {}       # per read group (we fold all RGs into one)
        self.qs_table = {}       # reported qual -> RecalDatum
        self.context_table = {}  # (qual, context_key) -> RecalDatum
        self.cycle_table = {}    # (qual, cycle_key) -> RecalDatum
        self.preserve = preserve_q_less_than
        self.global_prior = global_q_score_prior
        self.quantized = None

        for row in tables.get("RecalTable0", []):
            self.rg_table[row.get("ReadGroup", "")] = RecalDatum(
                int(float(row["Observations"])), float(row["Errors"]),
                float(row["EstimatedQReported"]))
        for row in tables.get("RecalTable1", []):
            q = int(row["QualityScore"])
            self.qs_table[q] = RecalDatum(
                int(float(row["Observations"])), float(row["Errors"]), q)
        for row in tables.get("RecalTable2", []):
            if row.get("EventType", "M") != "M":
                continue
            q = int(row["QualityScore"])
            val = row["CovariateValue"]
            datum = RecalDatum(int(float(row["Observations"])),
                               float(row["Errors"]), q)
            if row["CovariateName"] == "Context":
                codes = [_B2C.get(c, 4) for c in val]
                key = key_from_context(codes, 0, len(codes))
                if key >= 0:
                    self.context_table[(q, key)] = datum
            elif row["CovariateName"] == "Cycle":
                self.cycle_table[(q, key_from_cycle(int(val)))] = datum
        qrows = tables.get("Quantized", [])
        if qrows and quantization_levels >= 0:
            self.quantized = np.arange(94, dtype=np.int64)
            for row in qrows:
                self.quantized[int(row["QualityScore"])] = \
                    int(row["QuantizedScore"])

    def apply(self, read: dict) -> None:
        """Recalibrate read['quals'] in place
        (BQSRReadTransformer::apply)."""
        quals = np.asarray(read["quals"], np.int64)
        L = len(quals)
        if not self.rg_table:
            return
        rg = next(iter(self.rg_table.values()))
        epsilon = self.global_prior if self.global_prior > 0 \
            else rg.estimated_q_reported
        ctx = context_keys(read["seq_codes"], quals,
                           read.get("is_reverse", False))
        cyc = cycle_keys(L, read.get("is_reverse", False),
                         read.get("second_of_pair", False),
                         read.get("properly_paired", False)
                         or read.get("paired", False))
        out = quals.copy()
        for i in range(L):
            q = int(quals[i])
            if q < self.preserve:
                continue
            qs = self.qs_table.get(q)
            covs = []
            c = self.context_table.get((q, int(ctx[i])))
            if ctx[i] >= 0 and c is not None:
                covs.append(c)
            c = self.cycle_table.get((q, int(cyc[i])))
            if c is not None:
                covs.append(c)
            rq = self._hierarchical_estimate(epsilon, rg, qs, covs)
            rq = max(1, min(int(rq + 0.5), MAX_RECALIBRATION_Q_SCORE))
            if self.quantized is not None:
                rq = int(self.quantized[rq])
            out[i] = rq
        read["quals"] = out

    @staticmethod
    def _hierarchical_estimate(epsilon, rg, qs, covs):
        """hierarchicalBayesianQualityEstimate
        (BQSRReadTransformer.cpp:105-130)."""
        global_delta = 0.0 if rg is None else \
            rg.empirical_quality(epsilon) - epsilon
        delta_reported = 0.0 if qs is None else \
            qs.empirical_quality(global_delta + epsilon) \
            - (global_delta + epsilon)
        cond = delta_reported + global_delta + epsilon
        delta_cov = sum(c.empirical_quality(cond) - cond for c in covs)
        return epsilon + global_delta + delta_reported + delta_cov
