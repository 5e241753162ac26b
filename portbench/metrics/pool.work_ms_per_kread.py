"""pool.work_ms_per_kread (ms/kread): the finalize pool's workers' own
time on the window's batches (each worker times its call and
FinalizePool.collect adds the seconds to the port's PROF phase
POOL_WORK), per thousand reads. No trace of the main process sees it;
times the rate over the pool's size, it gives how busy the pool is.
Layer: the stream and its finalize pool (pipeline_stream.FinalizePool)."""


def read(t):
    if "POOL_WORK" not in t.prof_delta or not t.work:
        return None
    return 1e3 * t.prof_delta["POOL_WORK"] / t.kreads
