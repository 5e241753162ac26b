"""ladder.host_share (%): the escalation ladder's host work, the port's
own PROF phases ESC_PACK (copying the batch's regions, building each
rung chunk's codes, lengths and active flags) and ESC_MERGE (unpacking a
rung's regions and copying its rows and flags back), over the window.
Layer: pipeline.Aligner's ladder (_retry_overflow_inner)."""


def read(t):
    if "ESC_PACK" not in t.prof_delta or not t.window_len:
        return None
    return 100.0 * (t.prof_delta["ESC_PACK"]
                    + t.prof_delta.get("ESC_MERGE", 0.0)) / t.window_len
