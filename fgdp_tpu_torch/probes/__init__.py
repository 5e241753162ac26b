"""Card probes: the counterparts of the JAX package's two measurement
scripts, and the dependent-gather probe behind the seeding kernels'
serial bounds, each with its hand-written kernel and plain PyTorch
version.

  python -m fgdp_tpu_torch.probes.vpu_ceiling   (scripts/bench_vpu_ceiling.py)
  python -m fgdp_tpu_torch.probes.gather        (scripts/bench_gather_pallas.py)
  python -m fgdp_tpu_torch.probes.chase         (no TPU counterpart)

All need the CUDA card and print what they measure on it.
"""

from __future__ import annotations

import subprocess
import time

import torch

# Hopper lanes per SM and clock (one operation each, an FMA counted once)
FP32_LANES = 128
INT32_LANES = 64
# operations per unit of work of the port's kernels, counted from their
# sources; the bounds divide them by the issue rates
# int32 per DP cell of the recurrence as ksw_extend2 computes one cell
# (score, M, E, F, H, the row max): the work the SW bound counts, not the
# band masks and lanes the kernel (csrc/sw_extend.cuh) spends more on
SW_OPS_PER_CELL = 20
CHAIN_OPS_PER_SLOT = 6    # per seed step and chain slot (chain_loop.cuh)
# int32 per local-SW cell of the JAX package's kswv _forward, counted from
# its code as the operations on [J, QP] arrays in a row step (those on
# [1, QP] or [J, 1] arrays, such as jq * e_ins or tc >= 4, are not a
# cell's): the score (qc >= 4, the or, qc == tc, 2 selects), the mask's
# select, M (1), max(M, E, 0) (2), v (2 adds), the cummax (1), F (1), H
# (3 maxima and the mask's select), E (2 subtracts, 2 maxima), the row
# max (1), the best row's and the inactive rows' selects (2)
KSWV_OPS_PER_CELL = 24
# float32 per PairHMM cell (pairhmm.cuh): 5 for M, 3 for X, 1 for u, 6
# compares and selects of the match prior, and 2 per doubling of the scan
HMM_OPS_PER_CELL = 15
HMM_OPS_PER_DOUBLING = 2


def cuda_ms(fn, reps=10):
    """Mean ms per call over `reps` calls after a warm-up, by CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def wall_ms(fn):
    """Host ms of one call ended by a device sync, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def card():
    """(name and power limit as nvidia-smi prints them, the lane rates
    SMs x lanes x maximum SM clock in operations/s)."""
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    c = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    mhz = float(c.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return q.stdout.strip().splitlines()[0], dict(
        fp32=sms * FP32_LANES * mhz * 1e6, int32=sms * INT32_LANES * mhz * 1e6,
        sms=sms, mhz=mhz)
