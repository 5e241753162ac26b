"""ladder.escalated_share (%): reads passed to the escalation ladder
(Aligner._retry_overflow, the port's own count esc_reads) over the reads
aligned in the window. Layer: pipeline.Aligner's ladder."""


def read(t):
    if "esc_reads" not in t.counters or not t.work:
        return None
    return 100.0 * t.counters["esc_reads"] / t.work
