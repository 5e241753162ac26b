"""ladder.lane_fill (%): the reads a rung chunk held over the lanes it
was sized to (a power of two, 128 and up), the port's own counts
PROF.counts["ESC_ACTIVE"] over PROF.counts["ESC_LANES"], summed over the
window's rungs. Layer: pipeline.Aligner's ladder."""


def read(t):
    if not t.prof_counts.get("ESC_LANES"):
        return None
    return 100.0 * t.prof_counts.get("ESC_ACTIVE", 0) \
        / t.prof_counts["ESC_LANES"]
