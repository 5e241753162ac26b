"""FP32 and INT32 issue-rate probe (S1): the counterpart of the JAX
package's scripts/bench_vpu_ceiling.py, whose Pallas kernel it replaces
with csrc/vpu_ceiling.cu.

Every element of a (385, 2048) array runs 151 steps; each step builds
`n_chains` chains acc * 2^-c, runs 64 / n_chains rounds of
c * (0.999 - 1e-4 ci) + 1e-7 (ci + 1) on each chain, and sums the chains
back into acc. The sweep over n_chains in {4, 8, 16} shows how much
instruction-level parallelism the card needs to reach its issue rate.
The INT32 twin runs the same chain shape with a banded-SW cell's
operation mix (wrapping add, subtract, max), the rate that the SW
kernel's bound divides by.

The loop multiplies acc by 1.85-2.0 each step, so float32 overflows to
inf after about 130 steps for inputs in [0, 1), as it does in the JAX
script; the probe times the script's 151 steps, and `check` holds the
kernel against its plain version at the same shape over 40 steps, where
every value is finite.

    python -m fgdp_tpu_torch.probes.vpu_ceiling

needs the CUDA card. `vpu_ceiling` takes the kernel for CUDA tensors and
the plain version for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from . import (HMM_OPS_PER_CELL, HMM_OPS_PER_DOUBLING, SW_OPS_PER_CELL, card,
               cuda_ms, wall_ms)

ROWS, LANES, G = 385, 256, 8     # the script's PairHMM tile shape, 8 tiles
STEPS = 151
CHECK_STEPS = 40                 # every value finite (see the docstring)
N_FMA = 64                       # chain rounds x chains per step
CHAINS = (4, 8, 16)
INT_OPS_PER_ROUND = 3            # add, subtract, max
FP32_RTOL = 1e-5                 # fused (kernel) vs unfused (plain) rounding
# the PairHMM bench shape (2,048 pairs x 151 x 384) at its six doublings
P3_BENCH_CELLS = 2048 * 151 * 384
P3_OPS_PER_CELL = HMM_OPS_PER_CELL + 6 * HMM_OPS_PER_DOUBLING

_MAX = 16
# float32 constants exactly as the JAX script's jnp.float32(...) makes them
SCALE = np.array([1.0 / (1 << c) for c in range(_MAX)], np.float32)
MUL = np.array([0.999 - 1e-4 * c for c in range(_MAX)]).astype(np.float32)
ADD = np.array([1e-7 * (c + 1) for c in range(_MAX)]).astype(np.float32)
SEED = ((np.arange(_MAX, dtype=np.int64) * 0x9E3779B1) % (1 << 31)) \
    .astype(np.int32)
INC = (7 * np.arange(_MAX) + 3).astype(np.int32)
DEC = (5 * np.arange(_MAX) + 11).astype(np.int32)


def _check_args(x, steps, n_chains):
    if n_chains not in CHAINS:
        raise ValueError(f"vpu_ceiling: n_chains must be one of {CHAINS}")
    if steps < 0:
        raise ValueError("vpu_ceiling: steps must be >= 0")
    if x.dtype not in (torch.float32, torch.int32):
        raise ValueError("vpu_ceiling: x must be float32 or int32")


def vpu_ceiling_kernel(x, steps: int, n_chains: int):
    """Launch csrc/vpu_ceiling.cu on a CUDA tensor (float32: FMA chains,
    int32: the add/subtract/max twin); returns a new tensor."""
    _check_args(x, steps, n_chains)
    if not x.is_cuda:
        raise ValueError("vpu_ceiling kernel: x is not on a CUDA device")
    x = x.contiguous()
    out = torch.empty_like(x)
    lib = kernels.load("vpu_ceiling")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fgdp_vpu_ceiling(
            x.data_ptr(), out.data_ptr(), x.numel(), int(steps),
            int(n_chains), int(x.dtype == torch.int32),
            *(a.ctypes.data for a in (SCALE, MUL, ADD, SEED, INC, DEC)),
            stream)
    kernels.check(rc, "vpu_ceiling")
    kernels.LAUNCHES["vpu_ceiling"] += 1
    return out


def _consts(a, n, like):
    return torch.as_tensor(a[:n], device=like.device)[:, None]


def vpu_fp32_plain(x, steps: int, n_chains: int):
    """The script's loop in torch ops, a multiply then an add per chain
    round (the kernel fuses them; see FP32_RTOL)."""
    flat = x.reshape(-1)
    scale, mul, add = (_consts(a, n_chains, flat) for a in (SCALE, MUL, ADD))
    acc = flat.clone()
    for _ in range(steps):
        ch = acc[None, :] * scale
        for _ in range(N_FMA // n_chains):
            ch = ch * mul + add
        acc = ch[0]
        for c in ch[1:]:
            acc = acc + c
    return acc.reshape(x.shape)


def vpu_int32_plain(x, steps: int, n_chains: int):
    """The INT32 twin in torch ops (int32 arithmetic wraps)."""
    flat = x.reshape(-1)
    seed, inc, dec = (_consts(a, n_chains, flat) for a in (SEED, INC, DEC))
    acc = flat.clone()
    for _ in range(steps):
        ch = acc[None, :] ^ seed
        for _ in range(N_FMA // n_chains):
            ch = torch.maximum(ch + inc, ch - dec)
        acc = ch[0]
        for c in ch[1:]:
            acc = acc + c
    return acc.reshape(x.shape)


def vpu_ceiling_plain(x, steps: int, n_chains: int):
    _check_args(x, steps, n_chains)
    if x.dtype == torch.int32:
        return vpu_int32_plain(x, steps, n_chains)
    return vpu_fp32_plain(x, steps, n_chains)


def vpu_ceiling(x, steps: int, n_chains: int):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.is_cuda:
        return vpu_ceiling_kernel(x, steps, n_chains)
    return vpu_ceiling_plain(x, steps, n_chains)


def inputs(device, seed: int = 0):
    """The script's float32 input in [0, 1) and an int32 one, each
    (385, 2048)."""
    rng = np.random.default_rng(seed)
    xf = rng.random((ROWS, LANES * G), np.float32)
    xi = rng.integers(-2**31, 2**31, (ROWS, LANES * G)).astype(np.int32)
    return (torch.as_tensor(xf, device=device),
            torch.as_tensor(xi, device=device))


def ops_per_call(x, steps: int, n_chains: int):
    """Issue count the probe reports (an FMA or an add/sub/max round
    counts once per operation) and the work the bound counts: FLOPs for
    float32 (an FMA is two), operations for int32, overhead included."""
    n = x.numel() * steps
    if x.dtype == torch.float32:
        return n * N_FMA, n * (2 * N_FMA + 2 * n_chains - 1)
    issue = n * N_FMA * INT_OPS_PER_ROUND
    return issue, issue + n * (2 * n_chains - 1)


def check(device, steps: int = CHECK_STEPS):
    """Kernel against the plain version at the probe's shape for every
    chain count: float32 within FP32_RTOL, int32 exactly. Returns the
    largest relative float32 error."""
    worst = 0.0
    for x in inputs(device, seed=1):
        for n in CHAINS:
            got = vpu_ceiling_kernel(x, steps, n)
            want = vpu_ceiling_plain(x, steps, n)
            if x.dtype == torch.int32:
                if not torch.equal(got, want):
                    raise AssertionError(f"vpu_ceiling int32 n_chains={n} "
                                         "differs from its plain version")
                continue
            if not bool(torch.isfinite(want).all()):
                raise AssertionError("vpu_ceiling check: plain version "
                                     "overflowed")
            rel = float(((got - want).abs() / want.abs()).max())
            worst = max(worst, rel)
            if not rel <= FP32_RTOL:
                raise AssertionError(f"vpu_ceiling fp32 n_chains={n}: max "
                                     f"relative error {rel} > {FP32_RTOL}")
    return worst


def measure(device, reps: int = 10, log=print):
    """Time the sweep; returns one dict per (type, chain count) and the
    best issue rate of each type, in operations/s."""
    xf, xi = inputs(device)
    rows = []
    best = {}
    for kind, x in (("fp32", xf), ("int32", xi)):
        for n in CHAINS:
            ms = cuda_ms(lambda: vpu_ceiling_kernel(x, STEPS, n), reps)
            issue, work = ops_per_call(x, STEPS, n)
            rate = issue / (ms * 1e-3)
            rows.append(dict(kind=kind, n_chains=n, ms=ms, issue=issue,
                             work=work, rate=rate))
            best[kind] = max(best.get(kind, 0.0), rate)
            extra = f" ({2 * rate / 1e12:.2f} TFLOP/s counting FMA=2)" \
                if kind == "fp32" else " (add, sub, max one op each)"
            log(f"[vpu_ceiling] {kind} chains={n:2d}: {rate / 1e12:.2f} "
                f"Tops/s issued{extra}; {ms:.3f} ms/call")
    return rows, best


def main():
    if not torch.cuda.is_available():
        raise SystemExit("vpu_ceiling: needs a CUDA card")
    dev = torch.device("cuda")
    name, lanes = card()
    print(f"[vpu_ceiling] card: {name}; {lanes['sms']} SMs, max SM clock "
          f"{lanes['mhz']:.0f} MHz")
    err = check(dev)
    print(f"[vpu_ceiling] kernel vs plain over {CHECK_STEPS} steps: int32 "
          f"exact, fp32 max relative error {err:.3g} (<= {FP32_RTOL})")
    xf = inputs(dev)[0]
    plain, _ = wall_ms(lambda: vpu_ceiling_plain(xf, STEPS, 16))
    rows, best = measure(dev)
    print(f"[vpu_ceiling] plain version, fp32 chains=16: {plain:.1f} ms")
    for kind in ("fp32", "int32"):
        share = best[kind] / lanes[kind]
        print(f"[vpu_ceiling] best {kind}: {best[kind] / 1e12:.2f} Tops/s = "
              f"{100 * share:.1f}% of lanes x SMs x max clock "
              f"({lanes[kind] / 1e12:.2f} T/s)")
    p3 = [P3_BENCH_CELLS * P3_OPS_PER_CELL / r * 1e3
          for r in (lanes["fp32"], best["fp32"])]
    sw = [1e8 * SW_OPS_PER_CELL / r * 1e3
          for r in (lanes["int32"], best["int32"])]
    print(f"[vpu_ceiling] P3 bound at the bench shape ({P3_BENCH_CELLS} "
          f"cells x {P3_OPS_PER_CELL} ops): {p3[0]:.4f} ms at the lane "
          f"rate, {p3[1]:.4f} ms at the measured rate")
    print(f"[vpu_ceiling] SW bound per 1e8 cells ({SW_OPS_PER_CELL} ops): "
          f"{sw[0]:.4f} ms at the lane rate, {sw[1]:.4f} ms at the "
          f"measured rate")


if __name__ == "__main__":
    main()
