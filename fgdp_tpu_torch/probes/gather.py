"""Row-gather probe (S2): the counterpart of the JAX package's
scripts/bench_gather_pallas.py, whose Pallas kernel it replaces with
csrc/gather_rows.cu.

`gather_rows(tbl, idx)` is out[i, :] = tbl[idx[i], :]. The probe gathers
from an int32 table of 125,000 x 128 (64 MB, more than the card's 50 MB
L2) inside the script's chain of 64 dependent steps: gather, sum of the
first 24 columns, next index (i + (s & 1023) + 1) % 125,000. It sweeps
N in {1,024, 2,048} rows per step and D in {8, 16, 32} row reads in
flight, as the script does, plus N = 262,144, where one launch fills the
card, and prints ms per step, Mrows/s and GB/s.

    python -m fgdp_tpu_torch.probes.gather

needs the CUDA card. `gather_rows` takes the kernel for CUDA tensors and
the plain version, tbl[idx], for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from . import card, cuda_ms

W = 128
NBLOCKS = 125_000
STEPS = 64
SUM_COLS = 24
NS = (1024, 2048, 262_144)
DEPTHS = (8, 16, 32)
KERNEL_DEPTHS = (1, 2, 4, 8, 16, 32)


def gather_rows_kernel(tbl, idx, depth: int = 16, check: bool = True):
    """Launch csrc/gather_rows.cu on CUDA tensors: tbl int32[rows, w]
    (w a multiple of 4), idx int32[n]. `check` reads the indices' range
    back to the host (a sync) and raises on one outside [0, rows); the
    probe's chain, whose indices are in range by construction, skips it."""
    if not (tbl.is_cuda and idx.is_cuda and tbl.device == idx.device):
        raise ValueError("gather_rows kernel: tbl and idx must be on one "
                         "CUDA device")
    if tbl.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError("gather_rows kernel: tbl and idx must be int32")
    if tbl.dim() != 2 or idx.dim() != 1:
        raise ValueError("gather_rows kernel: tbl must be 2-D, idx 1-D")
    if tbl.shape[1] % 4 or depth not in KERNEL_DEPTHS:
        raise ValueError(f"gather_rows kernel: the row width must be a "
                         f"multiple of 4 and depth one of {KERNEL_DEPTHS}")
    tbl = tbl.contiguous()
    idx = idx.contiguous()
    if tbl.data_ptr() % 16:
        raise ValueError("gather_rows kernel: tbl is not 16-byte aligned")
    if check and idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= tbl.shape[0]:
            raise ValueError(f"gather_rows kernel: index out of range "
                             f"[0, {tbl.shape[0]}): {lo}..{hi}")
    out = torch.empty((idx.shape[0], tbl.shape[1]), dtype=torch.int32,
                      device=tbl.device)
    lib = kernels.load("gather_rows")
    with torch.cuda.device(tbl.device):
        stream = torch.cuda.current_stream(tbl.device).cuda_stream
        rc = lib.fgdp_gather_rows(tbl.data_ptr(), idx.data_ptr(),
                                  out.data_ptr(), idx.shape[0],
                                  tbl.shape[1], int(depth), stream)
    kernels.check(rc, "gather_rows")
    kernels.LAUNCHES["gather_rows"] += 1
    return out


def gather_rows_plain(tbl, idx):
    return tbl[idx.long()]


def gather_rows(tbl, idx, depth: int = 16, check: bool = True):
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if tbl.is_cuda:
        return gather_rows_kernel(tbl, idx, depth, check)
    return gather_rows_plain(tbl, idx)


def chain_step(tbl, idx, acc, gather):
    """One step of the script's chain: gather the rows, sum their first
    24 columns (int32, wrapping), step each index by that sum."""
    s = gather(tbl, idx)[:, :SUM_COLS].sum(dim=1, dtype=torch.int32)
    return (idx + (s & 1023) + 1) % tbl.shape[0], acc + s


def chain(tbl, i0, gather, steps: int = STEPS):
    """The script's chain of `steps` dependent steps; returns acc."""
    idx, acc = i0, torch.zeros_like(i0)
    for _ in range(steps):
        idx, acc = chain_step(tbl, idx, acc, gather)
    return acc


def table(device, seed: int = 0, rows: int = NBLOCKS):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 2**31, (rows, W), np.int64).astype(np.int32)
    return torch.as_tensor(t, device=device)


def indices(device, n: int, seed: int, rows: int = NBLOCKS):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, rows, n).astype(np.int32),
                           device=device)


def row_bytes(n: int) -> int:
    """Bytes a gather of n rows must move: each row read once and
    written once, and the indices."""
    return n * W * 4 * 2 + n * 4


def check(tbl, depths=KERNEL_DEPTHS):
    """Kernel against the plain version, exactly: single gathers at every
    depth and size, and one whole chain."""
    dev = tbl.device
    for n in NS + (1, 33):
        idx = indices(dev, n, seed=n)
        want = gather_rows_plain(tbl, idx)
        for d in depths:
            if not torch.equal(gather_rows_kernel(tbl, idx, d), want):
                raise AssertionError(f"gather_rows N={n} D={d} differs "
                                     "from its plain version")
    i0 = indices(dev, 2048, seed=5)
    got = chain(tbl, i0, lambda t, i: gather_rows_kernel(t, i, 16, False))
    if not torch.equal(got, chain(tbl, i0, gather_rows_plain)):
        raise AssertionError("gather_rows chain differs from the plain "
                             "chain")


def measure(tbl, reps: int = 5, log=print):
    """The sweep: per (N, D) the chain's ms per step, and the kernel's own
    ms per launch, Mrows/s and GB/s (bytes of row_bytes)."""
    dev = tbl.device
    out = []
    for n in NS:
        i0 = indices(dev, n, seed=7)
        for d in DEPTHS:
            g = lambda t, i: gather_rows_kernel(t, i, d, check=False)
            step_ms = cuda_ms(lambda: chain(tbl, i0, g), reps) / STEPS
            k_ms = cuda_ms(lambda: gather_rows_kernel(tbl, i0, d, False),
                           4 * reps)
            out.append(dict(n=n, depth=d, step_ms=step_ms, ms=k_ms))
            log(f"[gather] N={n:7d} D={d:2d}: chain64 {step_ms * 1e3:8.1f} "
                f"us/step ({n / step_ms / 1e3:8.1f} Mrows/s); kernel "
                f"{k_ms * 1e3:8.1f} us, {n / k_ms / 1e3:8.1f} Mrows/s, "
                f"{row_bytes(n) / k_ms / 1e6:7.1f} GB/s")
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("gather: needs a CUDA card")
    dev = torch.device("cuda")
    name, _ = card()
    print(f"[gather] card: {name}")
    tbl = table(dev)
    check(tbl)
    print("[gather] kernel equals tbl[idx] at every size and depth, and "
          "over a whole chain")
    measure(tbl)


if __name__ == "__main__":
    main()
