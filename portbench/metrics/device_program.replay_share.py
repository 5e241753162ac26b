"""device_program.replay_share (%): the card dispatches of the device
program that replayed a captured CUDA graph, the port's own counts
PROF.counts["DP_REPLAY"] over DP_REPLAY + DP_CAPTURE (dispatches that
captured their shape) + DP_EAGER (dispatches run op by op), over the
window. Layer: pipeline._GraphRunner, which Aligner._run dispatches
through."""

COUNTS = ("DP_REPLAY", "DP_CAPTURE", "DP_EAGER")


def read(t):
    n = sum(t.prof_counts.get(k, 0) for k in COUNTS)
    if not n:
        return None
    return 100.0 * t.prof_counts.get("DP_REPLAY", 0) / n
