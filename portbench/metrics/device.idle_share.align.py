"""device.idle_share.align (%): 1 - the union of the device's activity
(kernels, copies, sets) over a steady sub-window of the traced run, from
torch.profiler's CUDA trace of the run's own process. In a paired-end
cell the finalize pool's workers launch mate rescue (kswv) from their
own processes, which this trace does not see: it is the main process's
view of the card. Layer: the device."""


def read(t):
    if t.busy_s is None or not t.window_s or t.unit != "reads":
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
