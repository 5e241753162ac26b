"""Dependent-gather latency probe: the serial bounds of the seeding
kernels, independent of their designs (csrc/gather_chase.cu; no TPU
counterpart).

A chain hops through an FM occ table (int32[nblocks, 24], 96-byte
checkpoint rows): each hop gathers two whole rows and takes the next pair
from their sum, so every hop waits for the last. One chain alone gives
the latency of a seeding step's gather; K3's serial bound is its longest
read's gather steps times it. With `sync` every thread of a cooperative
grid passes one grid barrier a hop, cooperative_groups' grid sync
("coop") or the K1 and K2 kernels' own GridBar ("gridbar",
csrc/seed_waves.cuh, in the form the kernels take at that grid; "wide",
its two-word form at any grid); with no chain that times the barrier
alone, and K1's and K2's serial bounds are their grid steps times the
latency plus the cheapest of the barriers at their launch's grid.

    python -m fgdp_tpu_torch.probes.chase

needs the CUDA card; it chases a random table of the scale index's size
(288,000 rows, 27.6 MB) and prints the latencies, then the cold latency
on a random table of HUMAN_ROWS made on the card (17.28 GB, about the
occ rows of a 3.1 Gb index, whose gathers miss L2). `chase` takes the
kernel for CUDA tensors and the plain version (torch ops, one gather a
hop) for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from . import card

ROW = 24          # ints a checkpoint row
BARRIERS = {"coop": 1, "gridbar": 2, "wide": 3}   # the kernel's sync modes
HOPS = 2048       # hops of a timed lone chain
NBLOCKS = 288_000  # rows of the scale index's table (4.6 Mb, both strands)
HUMAN_ROWS = 180_000_000  # about a 3.1 Gb index's occ rows (18.6 GB)


def _start(p0, n, nblocks):
    p = (p0 + 7919 * np.arange(n, dtype=np.int64)) % nblocks
    return p, np.minimum(p + 1, nblocks - 1)


def chase_kernel(occ, chains: int, hops: int, p0: int = 0, blocks=None,
                 threads: int = 32, sync=None):
    """Launch csrc/gather_chase.cu on a CUDA occ table int32[nblocks, 24]:
    `chains` chains (one a thread) of `hops` hops from row p0 + 7919 t,
    on `blocks` x `threads` (default: as few blocks as hold the chains),
    cooperatively with a grid barrier a hop when `sync` names one of
    BARRIERS. Returns int32[chains, 2]: each chain's last sum and row."""
    if not occ.is_cuda or occ.dtype != torch.int32 or occ.dim() != 2 or \
            occ.shape[1] != ROW:
        raise ValueError("gather_chase kernel: occ must be int32[n, 24] "
                         "on a CUDA device")
    occ = occ.contiguous()
    if occ.data_ptr() % 16:
        raise ValueError("gather_chase kernel: occ is not 16-byte aligned")
    if blocks is None:
        blocks = max(-(-chains // threads), 1)
    out = torch.zeros((chains, 2), dtype=torch.int32, device=occ.device)
    slots = torch.zeros(6, dtype=torch.int64, device=occ.device)
    lib = kernels.load("gather_chase")
    kernels.launch("gather_chase", lib.fgdp_gather_chase, occ.data_ptr(),
                   occ.shape[0], chains, hops, blocks, threads,
                   BARRIERS[sync] if sync else 0, p0, out.data_ptr(),
                   slots.data_ptr(), device=occ.device)
    return out


def chase_plain(occ, chains: int, hops: int, p0: int = 0):
    """The same chains as torch ops: a gather of both rows a hop."""
    nblocks = occ.shape[0]
    p, q = (torch.as_tensor(a, device=occ.device)
            for a in _start(p0, chains, nblocks))
    x = torch.zeros(chains, dtype=torch.int64, device=occ.device)
    for h in range(hops):
        s = occ[p].long().sum(dim=1) + occ[q].long().sum(dim=1)
        s = s & 0xFFFFFFFF
        x = s
        p = ((s & 0x7FFFFFFF) * 40503 + h) % nblocks
        q = torch.clamp(p + ((s >> 8) & 3), max=nblocks - 1)
    x = torch.where(x >= 2**31, x - 2**32, x)
    return torch.stack([x, p], dim=1).to(torch.int32)


def chase(occ, chains: int, hops: int, p0: int = 0):
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if occ.is_cuda:
        return chase_kernel(occ, chains, hops, p0)
    return chase_plain(occ, chains, hops, p0)


def table(device, seed: int = 0, rows: int = NBLOCKS):
    """A random occ-shaped table (the probe's own, for runs without an
    index)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(-2**31, 2**31, (rows, ROW), np.int64).astype(np.int32)
    return torch.as_tensor(t, device=device)


def _kernel_ms(fn):
    """Kernel ms of one call of fn (a gather_chase launch) from the events
    its C entry point records."""
    kernels.TIMED["gather_chase"] = []
    try:
        fn()
        torch.cuda.synchronize()
        s, e = kernels.TIMED["gather_chase"][0]
    finally:
        kernels.TIMED.pop("gather_chase", None)
    return s.elapsed_time(e)


def latency_us(occ, hops: int = HOPS, p0: int = 12345):
    """(cold, warm) µs a hop of one chain alone: the first run's rows
    come from device memory or a cold L2, the second run repeats the
    chain's rows from L2 (its 393 KB of rows stay there; the loads skip
    L1)."""
    run = lambda: chase_kernel(occ, 1, hops, p0)
    cold = _kernel_ms(run)
    warm = _kernel_ms(run)
    return 1e3 * cold / hops, 1e3 * warm / hops


def barrier_us(occ, blocks: int, threads: int, hops: int = 1024,
               sync: str = "coop"):
    """µs a grid barrier (`sync`, one of BARRIERS) at a cooperative grid
    of blocks x threads (no chain: the hops are barriers alone), the
    barrier-only launch less a launch of no hops."""
    full = _kernel_ms(lambda: chase_kernel(occ, 0, hops, 0, blocks, threads,
                                           sync=sync))
    none = _kernel_ms(lambda: chase_kernel(occ, 0, 0, 0, blocks, threads,
                                           sync=sync))
    return 1e3 * (full - none) / hops


def check(occ, chains: int = 64, hops: int = 64):
    """The kernel against the plain version, exactly: chains alone and
    under each grid barrier a hop."""
    want = chase_plain(occ, chains, hops, 77)
    got = chase_kernel(occ, chains, hops, 77)
    if not torch.equal(got, want):
        raise AssertionError("gather_chase differs from its plain version")
    for sync in BARRIERS:
        got = chase_kernel(occ, chains, hops, 77, blocks=4, threads=32,
                           sync=sync)
        if not torch.equal(got, want):
            raise AssertionError(f"gather_chase under {sync} grid barriers "
                                 "differs from its plain version")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chase: needs a CUDA card")
    dev = torch.device("cuda")
    name, _ = card()
    print(f"[chase] card: {name}")
    occ = table(dev)
    check(occ)
    print("[chase] kernel equals the plain chase")
    cold, warm = latency_us(occ)
    print(f"[chase] one chain alone, {HOPS} hops of two 96-byte rows: cold "
          f"{cold:.3f} us a hop, warm (L2) {warm:.3f} us a hop")
    for blocks in (64, 128):
        print(f"[chase] grid barrier at {blocks} x 64 threads: " + ", ".join(
            f"{sync} {barrier_us(occ, blocks, 64, sync=sync):.3f} us"
            for sync in BARRIERS))
    del occ
    g = torch.Generator(device=dev).manual_seed(0)
    big = torch.randint(-2**31, 2**31 - 1, (HUMAN_ROWS, ROW),
                        dtype=torch.int32, device=dev, generator=g)
    cold, _ = latency_us(big)
    print(f"[chase] one chain alone on {HUMAN_ROWS} random rows "
          f"({big.numel() * 4 / 1e9:.2f} GB): cold {cold:.3f} us a hop")


if __name__ == "__main__":
    main()
