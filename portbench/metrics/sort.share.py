"""sort.share (%): the streaming sort's time on the main thread, the
port's own PROF phases SORT_FEED and SORT_FINISH (feeding the chunks,
then the duplicate scan, the sort and the BAM/BGZF/BAI write), over the
window. Layer: pipeline_stream.StreamingSortMarkdup, sortdup/, io/bam.py,
io/bgzf.py."""


def read(t):
    if not t.prof_delta.get("SORT_FINISH"):
        return None
    return 100.0 * (t.prof_delta.get("SORT_FEED", 0.0)
                    + t.prof_delta["SORT_FINISH"]) / t.window_len
