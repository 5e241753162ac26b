"""device_program.enqueue_share (%): the main thread's time enqueueing
the device program, the port's own PROF phases MEM_DEVICE (a primary
batch) and ESC_DISPATCH (a rung), less DP_SYNC (the host reads of device
values inside them, which wait for the card), over the window. Layer:
pipeline.device_align, align/, ops/ (the torch ops and kernel launches)."""


def read(t):
    if "ESC_DISPATCH" not in t.prof_delta or not t.window_len:
        return None
    s = t.prof_delta.get("MEM_DEVICE", 0.0) + t.prof_delta["ESC_DISPATCH"] \
        - t.prof_delta.get("DP_SYNC", 0.0)
    return 100.0 * s / t.window_len
