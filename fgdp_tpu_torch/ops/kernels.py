"""Build and load the port's hand-written CUDA kernels.

Each kernel source in csrc/ (sw_extend.cu, chain_loop.cu, chain_flt.cu,
kswv.cu, pairhmm.cu, the LCP engine's seeding kernels smem_lcp.cu,
k2_lcp.cu and seed_strategy.cu, the sweep engine's sweep_fwd.cu (D9, its
forward phase) and sweep_bwd.cu (D10, its backward phase), and the
probes' vpu_ceiling.cu, gather_rows.cu and gather_chase.cu) is
compiled by nvcc for sm_90a into its own shared library with a plain C
interface under build/fgdp_tpu_torch/ at the repository root, and bound
with ctypes. The build happens at first use (one nvcc per source, all started
together) and again whenever a source is newer than its library.

The C entry points launch on the stream they are given and return
cudaGetLastError(); `check` raises when that is not 0. While their stream
is being captured into a CUDA graph (pipeline._GraphRunner) they record
their event pair as external nodes of the graph (`fgdp_record` in
csrc/common.cuh), and the wrappers here count and time the capture's
launches through CAPTURE instead (`tally`, `event_pair`).

build_host_twin() compiles csrc/host_twin.cc with g++: the kernels' own
per-job, per-read and per-pair logic as a host library (one serial lane,
or 32 lanes in lockstep for the register paths of the chain loop, kswv
and PairHMM and for the chain filter; the seeding wave machines with every lane in one thread and
their counts taken step by step; the sweep's two phases one lane after
another, D9's lane as its group of 16 lockstep lanes), which the CPU
tests hold against the plain PyTorch versions
(tests/test_torch_sweep_kernels.py for D9 and D10). The port never runs
it.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import time

import torch

from ..io.native import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
KERNELS = ("chain_flt", "chain_loop", "gather_chase", "gather_rows",
           "k2_lcp", "kswv", "pairhmm", "seed_strategy", "smem_lcp",
           "sw_extend", "sweep_bwd", "sweep_fwd", "vpu_ceiling")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
# the FM-index as the seeding kernels take it (ops/fm.py's DeviceFMIndex):
# occ, nblocks, counts, c2, sa, sa_len and its four int scalars
_FM = [_P, _LL, _P, _P, _P, _LL] + [_I] * 4
# argument types of each C entry point: every pointer and the stream as
# c_void_p (ctypes would cut a Python int to 32 bits otherwise)
_SIGS = {
    "fgdp_chain_loop": [_P] * 6 + [_I] * 6 + [_P] * 4 + [_P] * 3 + [_P],
    "fgdp_sw_extend": [_P] * 5 + [_I] * 13 + [_P] * 5 + [_P],
    "fgdp_chain_loop_host": [_P] * 6 + [_I] * 6 + [_P] * 4,
    "fgdp_chain_loop_wide_host": [_P] * 6 + [_I] * 6 + [_P] * 4,
    "fgdp_chain_reg_max_c": [],
    "fgdp_chain_flt": [_P] * 8 + [_I] * 7 + [_F] * 2 + [_P] + [_P] * 3,
    "fgdp_chain_flt_host": [_P] * 8 + [_I] * 7 + [_F] * 2 + [_P],
    "fgdp_chain_flt_max_c": [],
    "fgdp_kswv": [_P] * 4 + [_I] * 9 + [_P] * 6 + [_P] * 3,
    "fgdp_kswv_host": [_P] * 4 + [_I] * 9 + [_P] * 4,
    "fgdp_kswv_wide_host": [_P] * 4 + [_I] * 9 + [_P] * 4,
    "fgdp_kswv_reg_max_qp": [],
    "fgdp_kswv_wide": [_I] * 3,
    "fgdp_sw_extend_host": [_P] * 5 + [_I] * 13 + [_P] * 2,
    "fgdp_pairhmm_f32": [_P] * 6 + [_I] * 4 + [_P] * 4 + [_P],
    "fgdp_pairhmm_f32_host": [_P] * 6 + [_I] * 4 + [_P],
    "fgdp_pairhmm_f32_wide_host": [_P] * 6 + [_I] * 4 + [_P],
    "fgdp_pairhmm_reg_max_h": [],
    "fgdp_vpu_ceiling": [_P, _P, _LL] + [_I] * 3 + [_P] * 6 + [_P],
    "fgdp_vpu_ceiling_host": [_P, _P, _LL] + [_I] * 3 + [_P] * 6,
    "fgdp_gather_rows": [_P] * 3 + [_LL] + [_I] * 2 + [_P],
    "fgdp_gather_chase": [_P, _LL] + [_I] * 5 + [_LL] + [_P] * 5,
    "fgdp_smem_lcp": _FM + [_P] * 6 + [_LL] + [_I] * 7 + [_P] * 6
    + [_P] * 3 + [_P] * 3,
    "fgdp_smem_lcp_host": _FM + [_P] * 6 + [_LL] + [_I] * 7 + [_P] * 6
    + [_I, _P, _I],
    "fgdp_lcp_walk_host": _FM + [_P] * 4 + [_LL] + [_I] * 6 + [_P] * 11
    + [_I],
    "fgdp_smem_lcp_max_blocks": [_I],
    "fgdp_smem_lcp_plan": [_I] * 2 + [_P],
    "fgdp_k2_lcp": _FM + [_P] * 10 + [_I] * 8 + [_P] * 6 + [_P] * 3
    + [_P] * 3,
    "fgdp_k2_lcp_host": _FM + [_P] * 10 + [_I] * 8 + [_P] * 6,
    "fgdp_k2_lcp_max_blocks": [_I],
    "fgdp_k2_lcp_grid": [_I, _P],
    "fgdp_seed_strategy": _FM + [_P] * 3 + [_I] * 5 + [_P] * 7 + [_P] * 3,
    "fgdp_seed_strategy_host": _FM + [_P] * 3 + [_I] * 5 + [_P] * 7 + [_I],
    "fgdp_fm_host": _FM + [_I] + [_P] * 6,
    "fgdp_sweep_fwd": _FM + [_P] * 7 + [_LL] + [_I] * 8 + [_P] * 7 + [_P]
    + [_P] * 3,
    "fgdp_sweep_fwd_host": _FM + [_P] * 7 + [_LL] + [_I] * 8 + [_P] * 7
    + [_P, _I, _P],
    "fgdp_sweep_fwd_staged": [_I],
    "fgdp_sweep_fwd_staged_host": [_I],
    "fgdp_sweep_bwd": _FM + [_P] * 9 + [_LL] + [_I] * 4 + [_P] * 3 + [_P]
    + [_P] * 3,
    "fgdp_sweep_bwd_host": _FM + [_P] * 9 + [_LL] + [_I] * 4 + [_P] * 3
    + [_P],
    "fgdp_fm_group_host": _FM + [_I] + [_P] * 6,
}

_libs: dict = {}
# last build's wall seconds and compiler messages per kernel
build_log: dict = {}
# launches per kernel: each wrapper adds one where it launches its
# kernel, and nowhere else (the smoke run reads these around the main
# path to show that the path went through the kernels). A replayed CUDA
# graph of the device program adds its captured launches on every
# replay, as if each had been launched again.
LAUNCHES = {name: 0 for name in KERNELS}
# CUDA event pairs (start, end) around each launch of a kernel, recorded
# only while a caller has put a list under its name (the smoke run's
# scale phases and the benchmark's traced run sum them into the kernel's
# time on the main path). The C entry points of SW, the chain loop, the
# chain filter, kswv, PairHMM and the seeding kernels (the sweep's too)
# record the pair themselves, right around the launch, so no host time
# falls between the two events. A replay of a captured device program
# appends one entry a captured launch of a timed kernel, once the fetch
# that follows the replay has folded it: an (Elapsed, None) pair whose
# first element's elapsed_time gives that replay's kernel ms, so that
# `sum(s.elapsed_time(e) for s, e in TIMED[name])` counts every replay.
TIMED: dict = {}
# the launches of the capture in progress (a Capture), None outside one
CAPTURE = None


class Capture:
    """What the wrappers launched while the device program was captured
    into a CUDA graph: `counts`, (counter dict, key) a launch (LAUNCHES or
    a path counter), which each replay adds again; `timed`, (kernel,
    start, end) external CUDA events that every replay records around the
    launch."""

    def __init__(self):
        self.counts = []
        self.timed = []


class Elapsed:
    """A replayed launch's kernel ms, as TIMED holds it: the first of an
    (Elapsed, None) pair, so that `s.elapsed_time(e)` reads it."""

    def __init__(self, ms: float):
        self.ms = ms

    def elapsed_time(self, end=None) -> float:
        return self.ms


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tally(counter: dict, key):
    """counter[key] += 1 for a launch; under a capture the capture keeps
    it, and each replay of the graph adds it."""
    if CAPTURE is not None:
        CAPTURE.counts.append((counter, key))
    else:
        counter[key] += 1


def event_pair(name: str, stream) -> list:
    """The [start, end] CUDA events the C entry point of kernel `name`
    records around its launch on `stream`, or [None, None] when no caller
    asked for its time (TIMED). A first record here makes torch create
    the events. Under a capture every launch gets an external pair, kept
    in CAPTURE: the graph records it on each replay, and the replay's fold
    reads it when TIMED asks for the kernel then."""
    if CAPTURE is not None:
        ev = [torch.cuda.Event(enable_timing=True, external=True)
              for _ in range(2)]
        CAPTURE.timed.append((name, *ev))
    else:
        timed = TIMED.get(name)
        if timed is None:
            return [None, None]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        timed.append(ev)
    for e in ev:
        e.record(stream)
    return ev


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def _so(name):
    return os.path.join(BUILD_DIR, name + ".so")


def _stale(so):
    if not os.path.exists(so):
        return True
    srcs = glob.glob(os.path.join(CSRC, "*.cu*")) + \
        glob.glob(os.path.join(CSRC, "*.cc"))
    return any(os.path.getmtime(s) > os.path.getmtime(so) for s in srcs)


def _start(cmd, so):
    """Start one compiler into a temporary name next to `so`; a rename
    publishes it once it succeeds (concurrent builders never see a half
    written library)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(cmd + ["-o", tmp], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name, proc, tmp, so, t0):
    out, _ = proc.communicate()
    build_log[name] = dict(seconds=time.time() - t0, log=out)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {name} failed:\n{out}")
    os.replace(tmp, so)


def build(names=KERNELS):
    """Compile every stale kernel library among `names`, all nvcc
    processes at once. Returns the wall seconds the build took."""
    t0 = time.time()
    jobs = []
    for name in names:
        so = _so(name)
        if _stale(so):
            cmd = [_nvcc()] + NVCC_FLAGS + [
                "-I", CSRC, os.path.join(CSRC, name + ".cu")]
            jobs.append((name, so) + _start(cmd, so))
    for name, so, proc, tmp in jobs:
        _finish(name, proc, tmp, so, t0)
    return time.time() - t0


def _bind(path):
    lib = ctypes.CDLL(path)
    for fn, args in _SIGS.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def load(name):
    """The loaded kernel library `name`, building every stale kernel at
    the first call."""
    lib = _libs.get(name)
    if lib is None:
        build(KERNELS)
        lib = _libs[name] = _bind(_so(name))
    return lib


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def tensor_arg(x, dev, dtype, what: str):
    """x as a contiguous `dtype` tensor for a C entry point; raises unless
    it lies on `dev`."""
    if x.device != dev:
        raise ValueError(f"{what} is on {x.device}, not on {dev}")
    return x.to(dtype).contiguous()


def work_ptr(work, dev, what: str, n: int = 4):
    """The address of a seeding kernel's work counters (a zeroed
    int64[n] on `dev`, csrc/seed_waves.cuh), or None when not asked
    for."""
    if work is None:
        return None
    if work.device != dev or work.dtype != torch.int64 or \
            work.shape != (n,):
        raise ValueError(f"{what}: work must be int64[{n}] on {dev}")
    return work.data_ptr()


def coop_grid(name: str, fn, n: int, device):
    """(blocks, threads) of the cooperative launch that the C entry point
    fn(n, grid) chooses for n lanes on `device`; raises when they cannot
    all be resident."""
    grid = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        if fn(n, ctypes.addressof(grid)) == 0:
            raise RuntimeError(f"{name}: {n} lanes cannot all be resident")
    return grid[0], grid[1]


def event_ptrs(ev) -> tuple:
    """An event pair as the C entry points take it (null for None)."""
    return tuple(e.cuda_event if e is not None else None for e in ev)


def launch(name: str, fn, *args, device):
    """Call the C entry point fn(*args, ev_start, ev_end, stream) on the
    current stream of `device`, with the event pair of `event_pair`;
    raises when the launch fails, else counts it (`tally`)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        ev = event_pair(name, stream)
        rc = fn(*args, *event_ptrs(ev), stream.cuda_stream)
    check(rc, name)
    tally(LAUNCHES, name)


def build_host_twin():
    """g++ build of csrc/host_twin.cc (test aid); returns the library."""
    lib = _libs.get("host_twin")
    if lib is None:
        so = _so("host_twin")
        if _stale(so):
            proc, tmp = _start(["g++", "-O2", "-std=c++17", "-shared",
                                "-fPIC", "-ffp-contract=off", "-fwrapv",
                                "-I", CSRC,
                                os.path.join(CSRC, "host_twin.cc")], so)
            _finish("host_twin", proc, tmp, so, time.time())
        lib = _libs["host_twin"] = _bind(so)
    return lib
