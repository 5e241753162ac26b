"""ladder.unresolved_share (%): reads still flagged overflowed when the
escalation ladder returns (the port's own count
PROF.counts["ESC_UNRESOLVED"]; such a read keeps its last rung's
regions, often none) over the reads passed to the ladder (the count
esc_reads). Layer: pipeline.Aligner's ladder."""


def read(t):
    if "ESC_UNRESOLVED" not in t.prof_counts or \
            not t.counters.get("esc_reads"):
        return None
    return 100.0 * t.prof_counts["ESC_UNRESOLVED"] / t.counters["esc_reads"]
