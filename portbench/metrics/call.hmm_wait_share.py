"""call.hmm_wait_share (%): the main process's wait for PairHMM results
(the port's own PROF phase HMM_WAIT: the sync and copy back in each
launch's collect), over the window. Layer: the region engine
(call/engine.Mutect2Engine, PairHMMBatcher)."""


def read(t):
    if t.unit != "regions" or "HMM_WAIT" not in t.prof_delta:
        return None
    return 100.0 * t.prof_delta["HMM_WAIT"] / t.window_len
