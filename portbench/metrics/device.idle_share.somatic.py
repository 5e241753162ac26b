"""device.idle_share.somatic (%): 1 - the union of the device's activity
(kernels, copies, sets) over a steady sub-window of the traced run, from
torch.profiler's CUDA trace of the run's process (the region workers
never touch the card). Layer: the device."""


def read(t):
    if t.busy_s is None or not t.window_s or t.unit != "regions":
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
