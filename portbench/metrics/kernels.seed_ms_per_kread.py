"""kernels.seed_ms_per_kread (ms/kread): the seeding kernels' time, the
port's CUDA event pairs around each launch (ops.kernels.TIMED) of K1
smem_lcp, K2 k2_lcp, K3 seed_strategy, D9 sweep_fwd and D10 sweep_bwd,
summed over the window, per thousand reads. Layer: the seeding kernels
(ops/smem_lcp.py, smem_k2lcp.py, smem.py, smem_sweep.py)."""

KERNELS = ("smem_lcp", "k2_lcp", "seed_strategy", "sweep_fwd", "sweep_bwd")


def read(t):
    if not t.work or not any(t.kernel_launches.get(k) for k in KERNELS):
        return None
    return sum(t.kernel_ms.get(k, 0.0) for k in KERNELS) / t.kreads
