"""stream.pool_wait_share (%): the main thread's time in
FinalizePool.collect, waiting for the finalize pool's SAM lines, over
the window (the benchmark's span around the call). Layer: the stream
and its finalize pool (pipeline_stream.stream_fastq_to_bam,
stream_mem_pooled, FinalizePool)."""


def read(t):
    if not t.calls.get("pool_wait"):
        return None
    return 100.0 * t.spans["pool_wait"] / t.window_len
