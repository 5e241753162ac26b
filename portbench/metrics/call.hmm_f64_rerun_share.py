"""call.hmm_f64_rerun_share (%): pairs whose float32 result underflowed
and were computed again in float64 on the host (the port's own count
PROF.counts["HMM_F64"]) over the pairs sent to the card (the benchmark's
count of the launches' pairs). Layer: the PairHMM batcher
(ops/pairhmm.py)."""


def read(t):
    if t.unit != "regions" or not t.counters.get("hmm_pairs"):
        return None
    return 100.0 * t.prof_counts.get("HMM_F64", 0) / t.counters["hmm_pairs"]
