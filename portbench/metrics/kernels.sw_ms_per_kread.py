"""kernels.sw_ms_per_kread (ms/kread): kernel P1's time (banded
Smith-Waterman extension, csrc/sw_extend.cu), the port's CUDA event
pairs around each launch, summed over the window, per thousand reads.
Layer: kernel P1 (ops/sw.py)."""


def read(t):
    if not t.work or not t.kernel_launches.get("sw_extend"):
        return None
    return t.kernel_ms["sw_extend"] / t.kreads
