"""device_program.sync_wait_share (%): the main thread's time in the
device program's host reads of device values (the port's own PROF phase
DP_SYNC, utils.profiling.host_read: each waits for all the work queued
on the card before it), over the window. Layer: pipeline.device_align,
align/, ops/."""


def read(t):
    if "DP_SYNC" not in t.prof_delta or not t.window_len:
        return None
    return 100.0 * t.prof_delta["DP_SYNC"] / t.window_len
