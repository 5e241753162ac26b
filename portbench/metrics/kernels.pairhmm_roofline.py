"""kernels.pairhmm_roofline (%): kernel P3's share of its roofline: the
least time the card could take for the window's PairHMM work over the
time the kernel took (the port's CUDA event pairs around each launch,
summed). The work is what the inputs need, whatever the implementation:
the DP cells, sum of read length x haplotype length over every pair the
window's launches computed (counted from the launches' inputs), times
the forward recurrence's 11 floating-point operations a cell (an FMA
counted as two: M 5, X 3, Y 3; reference/pairhmm.py), over the H100's
published 67 TFLOP/s in float32 outside the tensor cores (SXM, 700 W).
The bytes (a few per cell's row, read once) bound it far less. Layer:
kernel P3 (ops/pairhmm.py, csrc/pairhmm.cu)."""

FLOPS_PER_CELL = 11
PEAK_FLOPS = 67e12


def least_seconds(cells: int) -> float:
    return cells * FLOPS_PER_CELL / PEAK_FLOPS


def read(t):
    cells = t.counters.get("hmm_cells")
    ms = t.kernel_ms.get("pairhmm")
    if not cells or not ms or not t.kernel_launches.get("pairhmm"):
        return None
    return 100.0 * least_seconds(cells) / (ms / 1e3)
