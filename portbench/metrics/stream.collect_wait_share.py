"""stream.collect_wait_share (%): the main thread's wait for the
finalize pool's SAM lines, the port's own PROF phase POOL_WAIT around
FinalizePool.collect, over the window (the in-program twin of
stream.pool_wait_share, the benchmark's span around the same call).
Layer: the stream and its finalize pool (pipeline_stream)."""


def read(t):
    if "POOL_WAIT" not in t.prof_delta or not t.window_len:
        return None
    return 100.0 * t.prof_delta["POOL_WAIT"] / t.window_len
