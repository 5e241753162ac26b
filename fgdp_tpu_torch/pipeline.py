"""Single-host alignment pipeline: FASTQ batches -> SAM lines.

The device program runs seeding -> chaining -> batched banded-SW
extension as torch work on the aligner's device (the CUDA card unless
the caller asks for the CPU), with the two hand-written kernels on the
card (ops/sw.py, align/chain.py); the host finishes dedup/patch, primary
marking, CIGAR and SAM text — mirroring the reference's worker split
(worker_bwt/worker_aln on compute threads, worker_sam on output,
src/bwamem.cpp:1800-1850) with the device as the compute side.

Port of the JAX package's pipeline.py, single- and paired-end: a
paired batch's mate rescue runs on the aligner's device through the
kswv kernel (align/pair.rescue_all, ops/kswv.py). Escalated
rungs of the overflow ladder run on the same device through the same
kernels; the JAX package's defences against JAX and relay faults (salt
re-jit, relay-loss and transient retries, CPU-routed escalation and its
worker pool) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import time
import weakref

import numpy as np
import torch

from .align import chain as chainmod
from .align import extend as extendmod
from .align import finalize
from .align import pair as pairmod
from .align.seeding import collect_seeds
from .config import AlignConfig, BatchShapes
from .index.fmindex import FMIndex
from .index.lcptree import LcpTree
from .index.reference import DeviceReference, PackedReference
from .ops.fm import DeviceFMIndex
from .ops import kernels
from .ops.smem import compact_order
from .utils import dna
from .utils.device import resolve_device
from .utils.profiling import PROF, WORKER_SAM, host_read

_I32 = torch.int32
STAGES = ("seed", "chain", "extend", "pack")


def _add_stages(acc, marks):
    """Add the spans between (stage ended, CUDA event) marks to acc."""
    for (_, a), (name, b) in zip(marks, marks[1:]):
        acc[name] = acc.get(name, 0.0) + a.elapsed_time(b)


class _StageClock:
    """Per-stage ms of one device program run into a dict (off when the
    dict is None). On the card each stage boundary records a CUDA event
    on the current stream and nothing waits: `fold` adds each stage's
    span on the device's timeline once a fetch has waited for the
    events. On the CPU a stage is host wall time, added at its end.

    A captured program (_GraphRunner) keeps the marks of the clock it
    was captured with, external events that are nodes of its graph: each
    replay records them again, and the replay's fold (_Replay) adds their
    spans at the fetch that follows it, as `fold` does for a run op by
    op. A replay's spans are its stages on the device's timeline, with
    no host enqueueing inside them."""

    def __init__(self, acc, device, external=False):
        self.acc = acc
        self.external = external
        self.marks = []                 # (stage ended, its CUDA event)
        self.cuda = acc is not None and device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.current_stream(device)
            self.marks.append((None, self._event()))
        self.t = time.perf_counter()

    def _event(self):
        e = torch.cuda.Event(enable_timing=True, external=self.external)
        e.record(self.stream)
        return e

    def lap(self, name):
        if self.acc is None:
            return
        if self.cuda:
            self.marks.append((name, self._event()))
            return
        now = time.perf_counter()
        self.acc[name] = self.acc.get(name, 0.0) + 1e3 * (now - self.t)
        self.t = now

    def fold(self):
        """Add the recorded stages to the dict; call only once a fetch
        has waited for the run (its events are then done)."""
        _add_stages(self.acc, self.marks)
        self.marks = []


def device_align(dfm: DeviceFMIndex, dref: DeviceReference, codes, lens,
                 active, opt: AlignConfig, shapes: BatchShapes,
                 lcp_tree=None, lcp_isa=None, clock=None):
    """codes int[B, L] -> AlnRegBatch (compacted to transfer_regs).
    Seeding runs the LCP engine given a tree, else the sweep. `clock`, a
    _StageClock, times the stages seed, chain and extend."""
    clock = clock or _StageClock(None, codes.device)
    codes = codes.to(_I32)
    seeds = collect_seeds(dfm, dref, codes, lens, active, opt,
                          max_seeds=shapes.max_smems, lcp_tree=lcp_tree,
                          lcp_isa=lcp_isa, prev_cap=20,
                          scale=shapes.seed_scale,
                          k1_emit_cap=shapes.k1_emit_cap,
                          k3_emit_cap=shapes.k3_emit_cap,
                          k2_scale=shapes.k2_scale)
    clock.lap("seed")
    # flat-job pool sizing: the pool is shared first-come-first-served;
    # primary budget = 32 jobs/read average, escalated programs afford
    # the per-read worst case
    B_cur = codes.shape[0]
    jobs_cap = B_cur * (shapes.jobs_pool_per_read
                        or (32 if shapes.seed_scale == 1
                            else shapes.max_seeds))
    cb = chainmod.chain_seeds(dfm, dref, seeds, lens, opt,
                              max_seedpos=shapes.max_seeds,
                              max_chains=shapes.max_chains,
                              jobs_cap=jobs_cap)
    clock.lap("chain")
    regs = extendmod.extend_chains(cb, codes, lens, dref, opt,
                                   max_regs=shapes.max_regs,
                                   t_max=shapes.max_ext_ref,
                                   jobs_per_read=shapes.ext_jobs_per_read
                                   or 6 * shapes.seed_scale)
    clock.lap("extend")
    return compact_regs(regs, shapes.transfer_regs)


# reg fields that fit comfortably in int16 (offsets/scores bounded by
# read_len and a*read_len; rb/re are pac coordinates and stay wide)
_NARROW_FIELDS = ("qb", "qe", "score", "truesc", "sw_w", "seedcov",
                  "seedlen0")


def compact_regs(regs: "extendmod.AlnRegBatch", k: int):
    """Order each read's reg slots valid-first (stable) and keep only the
    first k columns, downcasting bounded fields to int16; a read with
    more than k valid regs sets its overflow flag and is re-run through
    the escalation ladder, which widens k alongside every other bound."""
    B, E = regs.valid.shape
    if k >= E:
        return regs
    counts = regs.valid.sum(dim=1, dtype=_I32)
    v = regs.valid.to(_I32)
    rank = torch.where(regs.valid, torch.cumsum(v, 1, dtype=_I32) - 1,
                       counts[:, None]
                       + torch.cumsum(1 - v, 1, dtype=_I32) - 1)
    # rank is a permutation of each row: invert it, keep the first k
    order = torch.empty_like(rank, dtype=torch.int64).scatter_(
        1, rank.long(), torch.arange(E, device=rank.device).expand(B, E)
    )[:, :k]
    fields = {}
    for name in regs._fields:
        a = getattr(regs, name)
        if a.dim() != 2:
            continue
        a = a.gather(1, order)
        if name in _NARROW_FIELDS:
            a = a.to(torch.int16)
        fields[name] = a
    return regs._replace(overflow=regs.overflow | (counts > k), **fields)


# reg-batch wire format: every AlnRegBatch field packed into ONE int32
# buffer, so the device->host copy is a single transfer
_PACK_I32 = ("rid", "rb", "re")
_PACK_I16 = ("qb", "qe", "score", "truesc", "sw_w", "seedcov",
             "seedlen0")


def _wrap32(x):
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    return ((x + 2**31) % 2**32 - 2**31).to(_I32)


def pack_regs(regs, cap_per_read: int = 4):
    """AlnRegBatch -> one flat int32[2 + 2B + 7*CAP] wire buffer.

    Only VALID reg slots ship: slots compact order-preservingly into
    CAP = cap_per_read * B rows of 7 words (rid, rb, re, qb|qe,
    score|truesc, sw_w|seedcov, seedlen0). Header: words 0-1 = E, B;
    per read, one word packing (count | overflow<<16 | ovf_seed<<17)
    and one frac_rep bitcast. Reads whose slots fall past CAP flag
    overflow (escalation re-runs them, like every other static cap)."""
    B, E = regs.valid.shape
    dev = regs.valid.device
    CAP = cap_per_read * B
    l_src, l_on = compact_order(regs.valid.reshape(-1), CAP)
    src = torch.where(l_on, l_src, 0).long()
    counts = regs.valid.sum(dim=1, dtype=_I32)
    csum = torch.cumsum(counts, 0, dtype=_I32)
    kept = torch.minimum(counts, (CAP - (csum - counts)).clamp(min=0))
    cap_ovf = kept < counts

    i16 = [getattr(regs, f).to(torch.int64).reshape(-1) for f in _PACK_I16]

    def pair(lo, hi):
        return _wrap32((lo & 0xffff) | ((hi & 0xffff) << 16))

    cols = [regs.rid.to(_I32).reshape(-1), regs.rb.to(_I32).reshape(-1),
            regs.re.to(_I32).reshape(-1), pair(i16[0], i16[1]),
            pair(i16[2], i16[3]), pair(i16[4], i16[5]),
            (i16[6] & 0xffff).to(_I32)]
    tbl = torch.stack(cols, dim=1)            # [B*E, 7]
    payload = torch.where(l_on[:, None], tbl[src], 0)
    ovf = regs.overflow | cap_ovf
    hdr = torch.stack(
        [kept | (ovf.to(_I32) << 16) | (regs.ovf_seed.to(_I32) << 17),
         regs.frac_rep.to(torch.float32).contiguous().view(_I32)], dim=1)
    head = torch.arange(2, dtype=_I32, device=dev) * (B - E) + E
    return torch.cat([head, hdr.reshape(-1), payload.reshape(-1)])


def unpack_regs(buf: np.ndarray) -> dict:
    """Inverse of pack_regs -> {field: np array} with [B, E] layouts
    matching AlnRegBatch._asdict() (int16 fields upcast to int32;
    invalid slots zero)."""
    buf = np.ascontiguousarray(buf)
    E, B = int(buf[0]), int(buf[1])
    hdr = buf[2:2 + 2 * B].reshape(B, 2)
    payload = buf[2 + 2 * B:].reshape(-1, 7)
    counts = hdr[:, 0] & 0xffff
    out = {"overflow": (hdr[:, 0] & (1 << 16)) != 0,
           "ovf_seed": (hdr[:, 0] & (1 << 17)) != 0,
           "frac_rep": hdr[:, 1].view(np.float32)}
    valid = np.arange(E, dtype=np.int32)[None, :] < counts[:, None]
    out["valid"] = valid
    offs = np.cumsum(counts) - counts
    rows = np.flatnonzero(valid.reshape(-1))
    b_of = rows // E
    e_of = rows % E
    src = offs[b_of] + e_of
    half = payload.astype(np.int32).view(np.int16).reshape(-1, 14)
    names_i16 = dict(zip(_PACK_I16, (6, 7, 8, 9, 10, 11, 12)))
    for i, f in enumerate(_PACK_I32):
        a = np.zeros((B, E), np.int32)
        a.reshape(-1)[rows] = payload[src, i]
        out[f] = a
    for f, col in names_i16.items():
        a = np.zeros((B, E), np.int32)
        a.reshape(-1)[rows] = half[src, col].astype(np.int32)
        out[f] = a
    return out


def device_align_packed(dfm, dref, codes, lens, active, opt, shapes,
                        lcp_tree=None, lcp_isa=None, clock=None):
    """device_align + single-buffer wire packing (see pack_regs); one
    `clock` times the four stages.

    Escalated programs (pack_cap=0) ship at full per-read width."""
    cap = shapes.pack_cap or shapes.transfer_regs
    clock = clock or _StageClock(None, codes.device)
    regs = device_align(dfm, dref, codes, lens, active, opt=opt,
                        shapes=shapes, lcp_tree=lcp_tree, lcp_isa=lcp_isa,
                        clock=clock)
    buf = pack_regs(regs, cap_per_read=cap)
    clock.lap("pack")
    return buf


_log = logging.getLogger(__name__)
_POOLS: dict = {}       # device index -> the _Pool its runners share


class _Pool:
    """What every runner on one card shares: the memory pool (a MemPool)
    that the warm runs allocate from and the graphs are captured into,
    and the side stream both run on (the caching allocator reuses a block
    only on the stream that freed it). Once every graph captured into it
    is gone (their Aligners with them), the next capture takes a new
    pool: torch's pinned-memory allocator refuses a pool id whose graphs
    all died."""

    def __init__(self, device):
        self.device = device            # with its index
        self.graphs = 0                 # live graphs captured into it
        self.held = False
        with torch.cuda.device(device):
            self.mem = torch.cuda.MemPool()
            self.side = torch.cuda.Stream(device)

    @staticmethod
    def of(device) -> "_Pool":
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        pool = _POOLS.get(idx)
        if pool is None or (pool.held and not pool.graphs):
            pool = _POOLS[idx] = _Pool(torch.device("cuda", idx))
        return pool

    def hold(self, graph):
        self.graphs += 1
        self.held = True
        weakref.finalize(graph, self._release)

    def _release(self):
        self.graphs -= 1


class _Staging:
    """Host buffers for one dispatch's inputs, bound to its shapes: numpy
    views `codes` int8[B, L], `lens` int32[B] and `active` bool[B] that
    the caller writes. On the card they are pinned, and `ready` is the
    event after their last copy to the card: the runner hands a staging
    out again only once that event is done."""

    def __init__(self, shapes, pin):
        B, L = shapes.batch_reads, shapes.read_len
        self.shapes = shapes
        self.host = (torch.empty((B, L), dtype=torch.int8, pin_memory=pin),
                     torch.empty(B, dtype=_I32, pin_memory=pin),
                     torch.empty(B, dtype=torch.bool, pin_memory=pin))
        self.codes, self.lens, self.active = (t.numpy() for t in self.host)
        self.ready = None


class _Program:
    """One shape's device program on the card: its static inputs, its
    graph and static output once captured (`eager` after a failed
    capture), what the capture launched (kernels.Capture) and its stage
    clock's marks, the free staging and pinned output buffers, and the
    replay whose events are not folded yet."""

    def __init__(self, shapes, device):
        B, L = shapes.batch_reads, shapes.read_len
        self.codes = torch.empty((B, L), dtype=torch.int8, device=device)
        self.lens = torch.empty(B, dtype=_I32, device=device)
        self.active = torch.empty(B, dtype=torch.bool, device=device)
        self.graph = self.out = self.launches = self.unfolded = None
        self.marks = []
        self.eager = False
        self.staging = []
        self.outs = []


class _Dispatch:
    """A card dispatch in flight: the pinned buffer its packed regs are
    copied into, and the event after that copy."""

    def __init__(self, prog, host, done):
        self.prog, self.host, self.done = prog, host, done


class _Replay:
    """A replay's events, folded at the fetch that follows it: the
    program's stage marks into `acc` (when a dict) and, for each captured
    launch of a kernel that TIMED asked for at the replay, one
    kernels.Elapsed entry of that replay's kernel ms."""

    def __init__(self, prog, acc):
        self.prog, self.acc, self.done = prog, acc, None
        self.timed = [(kernels.TIMED[name], a, b)
                      for name, a, b in prog.launches.timed
                      if kernels.TIMED.get(name) is not None]

    def __bool__(self):
        return self.acc is not None or bool(self.timed)

    def fold(self):
        if self.acc is not None:
            _add_stages(self.acc, self.prog.marks)
        for lst, a, b in self.timed:
            lst.append((kernels.Elapsed(a.elapsed_time(b)), None))
        if self.prog.unfolded is self:
            self.prog.unfolded = None


class _GraphRunner:
    """Dispatches an Aligner's device program, `program(shapes, codes,
    lens, active, clock)` -> packed reg buffer, and brings its result to
    the host.

    On the CPU a dispatch runs the program op by op, as it always has.
    On the card each distinct shape (the BatchShapes of a dispatch, its
    batch size included) is a _Program: its first dispatch runs the
    program op by op on a side stream (the warm run torch asks for before
    a capture; its result is that dispatch's), then captures it into a
    CUDA graph; every later dispatch of the shape copies the staged inputs
    into the program's static inputs (non-blocking, from pinned memory),
    replays the graph on the current stream and copies its static output
    into a pinned buffer of that dispatch alone, since the next replay
    overwrites it. Nothing in a replay waits for the card. A capture that
    raises leaves its shape to run op by op for good, and every shape
    not captured yet in this process too (a failed capture leaves state
    behind in torch's allocator that fails the captures after it); the
    exception is logged once, and the graphs captured before replay on.

    Every program of every runner on a device is captured into one
    memory pool, which the warm runs allocate from too (_Pool): a capture
    or a warm run may take memory that an earlier graph used for its
    temporaries, so two programs may write the same bytes. That is safe
    only because they all run in one order (the side stream waits for the
    current one before a warm run and a capture, the current one for the
    side stream after), each graph replays as a whole, and each run's
    output is copied out of the pool (stream-ordered) before any other
    program runs; the static inputs lie outside the pool. ShardedAligner's
    ten Aligners on one card thus hold one pool, about the size of the
    largest program's temporaries.

    Counts (PROF): DP_REPLAY, a dispatch replayed; DP_CAPTURE, a dispatch
    that captured its shape (phase DP_CAPTURE: the host's time capturing);
    DP_EAGER, a card dispatch run op by op (after a failed capture, or
    with `_force_eager` set on a runner or on the class: the card tests'
    and the smoke run's way to the op-by-op program).
    A replayed launch counts in kernels.LAUNCHES, and its kernel time and
    the stage clock's spans fold as a run's do (_Replay)."""

    _force_eager = False
    _capture_failed = False     # in this process, by any runner

    def __init__(self, device, program):
        self.device = device
        self.program = program
        self.cuda = device.type == "cuda"
        self.programs = {}          # shapes -> _Program
        self.pending = []           # dispatches whose events wait a fold

    def inputs(self, shapes) -> _Staging:
        """Host buffers for a dispatch of `shapes` (filled by the caller,
        then passed to `run`)."""
        if not self.cuda:
            return _Staging(shapes, pin=False)
        prog = self._program(shapes)
        for i, st in enumerate(prog.staging):
            if st.ready.query():
                return prog.staging.pop(i)
        return _Staging(shapes, pin=True)

    def _program(self, shapes):
        prog = self.programs.get(shapes)
        if prog is None:
            prog = self.programs[shapes] = _Program(shapes, self.device)
        return prog

    def run(self, st: _Staging, stage_ms):
        """Dispatch the program on `st`'s inputs; returns what `fetch`
        takes."""
        if not self.cuda:
            t = lambda a: host_read(torch.as_tensor, a, device=self.device)
            clock = _StageClock(stage_ms, self.device)
            return self.program(st.shapes, t(st.codes), t(st.lens),
                                t(st.active), clock)
        stream = torch.cuda.current_stream(self.device)
        prog = self._program(st.shapes)
        for dst, src in zip((prog.codes, prog.lens, prog.active), st.host):
            dst.copy_(src, non_blocking=True)
        st.ready = torch.cuda.Event()
        st.ready.record(stream)
        prog.staging.append(st)
        if prog.graph is None or self._force_eager:
            return self._eager(prog, st.shapes, stage_ms, stream)
        last = prog.unfolded
        if last is not None:
            # this replay records its events again: fold the last one's
            # first (the stream keeps primaries in flight between fetches)
            host_read(last.done.synchronize)
            last.fold()
            self.pending.remove(last)
        prog.graph.replay()
        for counter, key in prog.launches.counts:
            counter[key] += 1
        PROF.count("DP_REPLAY")
        rep = _Replay(prog, stage_ms)
        if rep:
            prog.unfolded = rep
        return self._out(prog, prog.out, stream, rep or None)

    def _eager(self, prog, shapes, stage_ms, stream):
        """The program op by op; on a shape's first dispatch, on a side
        stream and followed by its capture."""
        if prog.eager or self._force_eager or \
                _GraphRunner._capture_failed:
            PROF.count("DP_EAGER")
            clock = _StageClock(stage_ms, self.device)
            out = self.program(shapes, prog.codes, prog.lens, prog.active,
                               clock)
            return self._out(prog, out, stream, clock if clock.marks
                             else None)
        pool = _Pool.of(self.device)
        pool.side.wait_stream(stream)
        with torch.cuda.stream(pool.side):
            clock = _StageClock(stage_ms, self.device)
            with torch.cuda.use_mem_pool(pool.mem, device=pool.device):
                out = self.program(shapes, prog.codes, prog.lens,
                                   prog.active, clock)
            with PROF.phase("DP_CAPTURE"):
                captured = self._capture(prog, shapes, pool)
        stream.wait_stream(pool.side)
        out.record_stream(stream)
        PROF.count("DP_CAPTURE" if captured else "DP_EAGER")
        return self._out(prog, out, stream, clock if clock.marks else None)

    def _capture(self, prog, shapes, pool) -> bool:
        graph = torch.cuda.CUDAGraph()
        launches = kernels.Capture()
        kernels.CAPTURE = launches
        # the collector may free other graphs or events, which a capture
        # does not permit (it would be invalidated)
        collect = gc.isenabled()
        gc.disable()
        try:
            graph.capture_begin(pool=pool.mem.id,
                                capture_error_mode="thread_local")
            try:
                clock = _StageClock({}, self.device, external=True)
                out = self.program(shapes, prog.codes, prog.lens,
                                   prog.active, clock)
            finally:
                graph.capture_end()
        except Exception as e:          # noqa: BLE001 - any fault of a capture
            prog.eager = True
            if not _GraphRunner._capture_failed:
                _GraphRunner._capture_failed = True
                _log.warning("capturing the device program of %s failed; "
                             "it and the shapes not captured yet run op by "
                             "op: %r", shapes, e, exc_info=True)
            return False
        finally:
            kernels.CAPTURE = None
            if collect:
                gc.enable()
        pool.hold(graph)
        prog.graph, prog.out, prog.launches = graph, out, launches
        prog.marks = clock.marks
        return True

    def _out(self, prog, out, stream, fold):
        host = prog.outs.pop() if prog.outs else torch.empty(
            out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        if fold is not None:
            fold.done = done
            self.pending.append(fold)
        return _Dispatch(prog, host, done)

    def fetch(self, d) -> np.ndarray:
        """A dispatch's packed reg buffer on the host. On the card this
        waits for its copy's event and, when events wait a fold, for the
        newest dispatch's (the work queued since comes with it, as a
        blocking copy's wait would), then folds them all."""
        if not self.cuda:
            return d.cpu().numpy()
        d.done.synchronize()
        if self.pending:
            self.pending[-1].done.synchronize()
            for f in self.pending:
                f.fold()
            self.pending.clear()
        out = d.host.numpy().copy()
        d.prog.outs.append(d.host)
        return out


class Aligner:
    """End-to-end single- and paired-end aligner over one reference.

    device=None runs on the CUDA card and raises without one; pass
    device="cpu" to run on the CPU. On the card each shape of the device
    program is captured into a CUDA graph at its first dispatch and
    replayed after (_GraphRunner). `stage_ms` / `esc_stage_ms`, when set
    to dicts, accumulate per-stage ms of the primary and the escalated
    device runs (_StageClock: on the card each stage's span on the
    device's timeline, added at the fetch that follows it; nothing waits
    for the card on its account)."""

    ESCALATE_LEVELS = 2

    def __init__(self, pref: PackedReference, fm: FMIndex,
                 opt: AlignConfig | None = None,
                 shapes: BatchShapes | None = None,
                 lcp: LcpTree | bool | None = True, device=None):
        self.device = resolve_device(device)
        self.pref = pref
        self.opt = opt or AlignConfig()
        self.shapes = shapes or BatchShapes()
        self.dref = DeviceReference(pref, self.device)
        self.dfm = DeviceFMIndex.from_host(fm, self.device)
        # K1/K2 seeding engine, as in the JAX package: the LCP-tree
        # machines by default (lcp=True builds the tree from the index's
        # SA; pass a loaded LcpTree to skip the build), the sweep for
        # lcp=None/False
        if lcp is True:
            x = np.concatenate([pref.codes,
                                dna.revcomp(pref.codes)]).astype(np.uint8)
            lcp = LcpTree.build(x, fm.sa)
        if lcp:
            self.lcp_tree = torch.as_tensor(lcp.tree, device=self.device)
            self.lcp_isa = torch.as_tensor(lcp.isa, device=self.device)
        else:
            self.lcp_tree = self.lcp_isa = None
        # host-only output options don't shape the device program
        self._dev_opt = dataclasses.replace(self.opt, output_all=False)
        self.stage_ms = None
        self.esc_stage_ms = None
        self._graphs = _GraphRunner(self.device, self._program)
        self.esc_reads = 0
        self.esc_calls = 0

    @classmethod
    def build(cls, pref: PackedReference, **kw) -> "Aligner":
        return cls(pref, FMIndex.build(pref.codes), **kw)

    def sam_header(self, rg_line=None):
        lines = ["@HD\tVN:1.6\tSO:unsorted"]
        for i, (name, ln) in enumerate(zip(self.pref.names,
                                           self.pref.lens)):
            ah = "\tAH:*" if bool(self.pref.is_alt[i]) else ""
            lines.append(f"@SQ\tSN:{name}\tLN:{int(ln)}{ah}")
        if rg_line:
            lines.append(rg_line)
        lines.append("@PG\tID:fgdp-tpu\tPN:fgdp-tpu\tVN:0.1")
        return lines

    def align_batch(self, names, seq_codes, quals=None, id0: int = 0):
        """Single-end alignment. names: list[str]; seq_codes: list of int
        arrays (0..4). Returns SAM lines (one or more per read)."""
        regs_np = self._device_regs(seq_codes)
        return self.finalize_batch(names, seq_codes, quals, regs_np, id0)

    def align_pairs(self, names, seq_codes, quals=None, id0: int = 0):
        """Paired-end alignment. seq_codes interleaved [r1_0, r2_0, r1_1,
        ...] (reference worker layout, bseq 2i/2i+1). Returns SAM lines."""
        assert len(seq_codes) % 2 == 0
        regs_np = self._device_regs(seq_codes)
        return self.finalize_batch(names, seq_codes, quals, regs_np, id0,
                                   paired=True)

    def _program(self, shapes, codes, lens, active, clock):
        return device_align_packed(
            self.dfm, self.dref, codes, lens, active, opt=self._dev_opt,
            shapes=shapes, lcp_tree=self.lcp_tree, lcp_isa=self.lcp_isa,
            clock=clock)

    @property
    def _clocks(self):
        """Dispatches whose stage clock or kernel events wait a fold."""
        return self._graphs.pending

    def _run(self, staged, stage_ms):
        """One device program run on a _Staging's inputs -> a dispatch
        that _fetch brings to the host."""
        return self._graphs.run(staged, stage_ms)

    def _fetch(self, buf) -> np.ndarray:
        """A dispatch's packed reg buffer on the host; the stage clocks
        and kernel events of the runs dispatched so far fold here."""
        return self._graphs.fetch(buf)

    def _device_regs_async(self, seq_codes):
        """Dispatch the primary device program for one batch; returns
        the dispatch (_run)."""
        B = len(seq_codes)
        L = self.shapes.read_len
        shapes = self.shapes if B == self.shapes.batch_reads else \
            dataclasses.replace(self.shapes, batch_reads=B)
        st = self._graphs.inputs(shapes)
        st.codes.fill(4)
        for i, s in enumerate(seq_codes):
            n = min(len(s), L)
            st.codes[i, :n] = np.asarray(s[:n], np.int8)
            st.lens[i] = n
        st.active.fill(True)
        with PROF.phase("MEM_DEVICE"):
            return self._run(st, self.stage_ms)

    def _regs_to_np(self, regs, seq_codes=None):
        out = unpack_regs(self._fetch(regs))
        if seq_codes is not None:
            out = self._retry_overflow(out, seq_codes)
        return out

    def _escalated_shapes(self, level: int):
        """Full escalation (seed-stage overflow): every cap doubles per
        level, incl. the seeding-internal pools via seed_scale; the
        chain seed-position table gets an extra 2x."""
        f = 2 ** level
        s = self.shapes
        return dataclasses.replace(
            s, max_smems=s.max_smems * f, max_seeds=s.max_seeds * 2 * f,
            max_chains=s.max_chains * f, max_regs=s.max_regs * f,
            transfer_regs=s.transfer_regs * f, pack_cap=0,
            seed_scale=s.seed_scale * f)

    def _k2_wide_shapes(self, level: int):
        """Targeted escalation for seed-stage overflow: K1 reruns at 1x
        rounds/cost, K2 pools widen, and the chain/extend shapes widen
        like the chain-wide flavor. The full flavor remains the level-2
        backstop."""
        f = 2 ** level
        s = self.shapes
        return dataclasses.replace(
            s, seed_scale=1, k2_scale=2 * f, max_smems=s.max_smems * f,
            max_seeds=s.max_seeds * 2 * f, max_chains=s.max_chains * f,
            max_regs=s.max_regs * f, transfer_regs=s.transfer_regs * f,
            pack_cap=0, jobs_pool_per_read=s.max_seeds * 2 * f,
            ext_jobs_per_read=6 * f)

    def _chain_wide_shapes(self, level: int):
        """Targeted escalation for reads whose seeding fit but whose
        chain/extension/transfer stages overflowed: seeding reruns at 1x
        cost, only the chain table, job pools, and reg slots widen."""
        f = 2 ** level
        s = self.shapes
        return dataclasses.replace(
            s, max_seeds=s.max_seeds * 2 * f, max_chains=s.max_chains * f,
            max_regs=s.max_regs * f, transfer_regs=s.transfer_regs * f,
            pack_cap=0, jobs_pool_per_read=s.max_seeds * 2 * f,
            ext_jobs_per_read=6 * f)

    def _rung_shapes(self, flavor, level, B_esc):
        mk = {"full": self._escalated_shapes,
              "k2w": self._k2_wide_shapes,
              "cw": self._chain_wide_shapes}[flavor]
        return dataclasses.replace(mk(level), batch_reads=B_esc)

    def _esc_exec(self, flavor, level, staged):
        """Run one escalated chunk of the rung (flavor, level) on the
        aligner's device; returns its packed reg buffer on the host."""
        with PROF.phase("ESC_DISPATCH"):
            buf = self._run(staged, self.esc_stage_ms)
        with PROF.phase("ESC_FETCH"):
            return self._fetch(buf)

    def _retry_overflow(self, regs_np, seq_codes):
        """Re-run overflowed reads through progressively wider device
        buckets (the reference reallocs per-read seed/chain arrays at
        will; under static shapes a read that exceeds a cap sets its
        overflow flag and is retried at 2x, 4x, ... shapes)."""
        ovf = regs_np.get("overflow")
        if ovf is None or not np.any(ovf):
            return regs_np
        with PROF.phase("ESC_RETRY"):
            return self._retry_overflow_inner(regs_np, seq_codes)

    def _retry_overflow_inner(self, regs_np, seq_codes):
        with PROF.phase("ESC_PACK"):
            regs_np = {k: np.array(v) for k, v in regs_np.items()}
        ovf = regs_np["overflow"]
        idx = np.flatnonzero(np.asarray(ovf))
        # cause routing: seeding-stage overflow needs the wider seeding
        # machines; chain/extension/transfer overflow re-runs with 1x
        # seeding and wide chain shapes
        seed_flag = np.asarray(regs_np.get(
            "ovf_seed", np.zeros(len(ovf), bool))).copy()
        self.esc_reads += len(idx)
        L = self.shapes.read_len

        for level in range(1, self.ESCALATE_LEVELS + 1):
            still = []
            seed_fl = "k2w" if level == 1 else "full"
            for flavor in (seed_fl, "cw"):
                want = seed_flag[idx] if flavor != "cw" \
                    else ~seed_flag[idx]
                sub_idx = idx[want]
                if len(sub_idx) == 0:
                    continue
                # power-of-two buckets, as the JAX package sizes them
                cap_fl = {"k2w": 1024, "cw": 2048, "full": 512}[flavor]
                B_esc = 128
                while B_esc < min(len(sub_idx), cap_fl):
                    B_esc *= 2
                for c0 in range(0, len(sub_idx), B_esc):
                    self.esc_calls += 1
                    chunk = sub_idx[c0:c0 + B_esc]
                    PROF.count("ESC_ACTIVE", len(chunk))
                    PROF.count("ESC_LANES", B_esc)
                    with PROF.phase("ESC_PACK"):
                        st = self._graphs.inputs(
                            self._rung_shapes(flavor, level, B_esc))
                        st.codes.fill(4)
                        st.lens.fill(0)
                        st.active.fill(False)
                        for j, b in enumerate(chunk):
                            s = seq_codes[b]
                            n = min(len(s), L)
                            st.codes[j, :n] = np.asarray(s[:n], np.int8)
                            st.lens[j] = n
                            st.active[j] = True
                    buf = self._esc_exec(flavor, level, st)
                    with PROF.phase("ESC_MERGE"):
                        still += self._esc_merge(regs_np, seed_flag,
                                                 chunk, unpack_regs(buf))
            idx = np.asarray(sorted(still), dtype=np.int64)
            if len(idx) == 0:
                break
        PROF.count("ESC_UNRESOLVED", int(np.count_nonzero(
            regs_np["overflow"])))
        return regs_np

    @staticmethod
    def _esc_merge(regs_np, seed_flag, chunk, sub_np):
        """Copy a rung's rows and flags over its reads' (widening the
        batch's reg slots to the rung's first); returns the reads that
        overflowed again."""
        B = len(regs_np["overflow"])
        E_new = sub_np["valid"].shape[1]
        E_cur = regs_np["valid"].shape[1]
        if E_new > E_cur:
            for k, v in regs_np.items():
                if v.ndim == 2:
                    pad = np.zeros((B, E_new - E_cur), v.dtype)
                    regs_np[k] = np.concatenate([v, pad], axis=1)
        still = []
        for j, b in enumerate(chunk):
            for k, v in regs_np.items():
                if v.ndim == 2:
                    v[b] = sub_np[k][j]
            regs_np["overflow"][b] = sub_np["overflow"][j]
            # a cw re-run that NOW flags seeding overflow promotes to
            # the full flavor next level
            seed_flag[b] = bool(sub_np["ovf_seed"][j])
            if sub_np["overflow"][j]:
                still.append(b)
        return still

    def _device_regs(self, seq_codes):
        regs = self._device_regs_async(seq_codes)
        return self._regs_to_np(regs, seq_codes)

    def finalize_batch(self, names, seq_codes, quals, regs_np, id0,
                       paired=False):
        """Host finalize of one batch's device regs -> SAM lines (a
        paired batch's mate rescue on the aligner's device)."""
        with PROF.phase(WORKER_SAM):
            if paired:
                return finalize_pe_batch(self.pref, self.opt, names,
                                         seq_codes, quals, regs_np, id0,
                                         self.device)
            return finalize_se_batch(self.pref, self.opt, self.shapes,
                                     names, seq_codes, quals, regs_np,
                                     id0)


def finalize_se_batch(pref, opt, shapes, names, seq_codes, quals, regs_np,
                      id0):
    """Host finalize for a single-end batch: device regs -> SAM lines.
    Module-level and numpy-only so worker processes can run it
    (pipeline_stream.FinalizePool)."""
    reg_lists = _reg_lists_np(pref, opt, seq_codes, regs_np)
    # id0 may be a scalar base (ids = id0 + row) or a per-read id array
    # (the deferred-escalation flush finalizes reads gathered from many
    # batches; ids feed the hash_64 tie-breaks so they must be the
    # reads' ORIGINAL global ids for output identical to the sync path)
    ids = id0 if np.ndim(id0) else id0 + np.arange(len(reg_lists))
    # batch the reg2aln DP (CIGAR/MD) across the whole read batch
    jobs = []
    job_of = []
    for b, rl in enumerate(reg_lists):
        finalize.mark_primary(opt, rl, int(ids[b]))
        codes = np.asarray(seq_codes[b], np.int64)
        for k in finalize.selected_regs(opt, rl):
            jobs.append((codes, rl[k]))
            job_of.append((b, k))
    alns = finalize.reg2aln_batch(pref, opt, jobs) if jobs else []
    aln_maps = [dict() for _ in reg_lists]
    for (b, k), a in zip(job_of, alns):
        aln_maps[b][k] = a
    out = []
    for b, rl in enumerate(reg_lists):
        qual = quals[b] if quals else None
        out.extend(finalize.reg2sam(
            pref, opt, names[b], np.asarray(seq_codes[b], np.int64),
            qual, rl, int(ids[b]), alns_by_k=aln_maps[b]))
    return out


def finalize_pe_batch(pref, opt, names, seq_codes, quals, regs_np, id0,
                      device):
    """Finalize for a paired-end batch (insert-size inference + mate
    rescue on `device` + pairing + SAM); module-level for worker
    processes. seq_codes are interleaved [r1_0, r2_0, ...]; id0 counts
    PAIRS."""
    B = len(seq_codes)
    reg_lists = _reg_lists_np(pref, opt, seq_codes, regs_np)
    reg_pairs = [(reg_lists[2 * i], reg_lists[2 * i + 1])
                 for i in range(B // 2)]
    pes = pairmod.pestat(opt, pref.l_pac, reg_pairs)
    codes_pairs = [(np.asarray(seq_codes[2 * i], np.int64),
                    np.asarray(seq_codes[2 * i + 1], np.int64))
                   for i in range(B // 2)]
    # batched mate rescue (kswv analogue) across the whole batch
    pairmod.rescue_all(opt, pref, pes, reg_pairs, codes_pairs,
                       device=device)
    # plan every pair first, then ONE batched reg2aln DP over all
    # selected regs (the SE path's batching; the scalar per-reg DP
    # measured 5.8 s of a 4096-read batch = ~85% of PE finalize)
    plans = [pairmod.sam_pe_plan(opt, pref, pes, id0 + i,
                                 list(reg_pairs[i]))
             for i in range(B // 2)]
    jobs, jkeys = [], {}
    for i, plan in enumerate(plans):
        a = reg_pairs[i]
        if plan["mode"] == "paired":
            want = [(e, plan["z"][e]) for e in (0, 1)]
        else:
            want = [(e, plan["which"][e]) for e in (0, 1)
                    if plan["which"][e] is not None]
            want += [(e, k) for e in (0, 1)
                     for k in finalize.selected_regs(opt, a[e])]
        for e, k in want:
            if (i, e, k) not in jkeys:
                jkeys[(i, e, k)] = len(jobs)
                jobs.append((codes_pairs[i][e], a[e][k]))
    alns = finalize.reg2aln_batch(pref, opt, jobs) if jobs else []
    per_pair = {}
    for (i, e, k), j in jkeys.items():
        per_pair.setdefault(i, ({}, {}))[e][k] = j
    out = []
    for i, plan in enumerate(plans):
        a = reg_pairs[i]
        pj = per_pair.get(i, ({}, {}))

        def aln_of(e, k, i=i, pj=pj):
            if k is None:
                return finalize.reg2aln(pref, opt, codes_pairs[i][e],
                                        None)
            j = pj[e].get(k)
            # reg2aln mutates nothing, but aln dicts are mutated by the
            # emitters (flags/mapq/xa) — hand each consumer a copy
            return dict(alns[j]) if j is not None else finalize.reg2aln(
                pref, opt, codes_pairs[i][e], a[e][k])

        maps = ({k: dict(alns[j]) for k, j in pj[0].items()},
                {k: dict(alns[j]) for k, j in pj[1].items()})
        q1 = quals[2 * i] if quals else None
        q2 = quals[2 * i + 1] if quals else None
        l0, l1 = pairmod.sam_pe_emit(
            opt, pref, plan, id0 + i,
            (names[2 * i], names[2 * i + 1]), codes_pairs[i],
            (q1, q2), list(reg_pairs[i]), aln_of=aln_of,
            alns_by_k=maps)
        out.extend(l0)
        out.extend(l1)
    return out


def _reg_lists_np(pref, opt, seq_codes, regs):
    """Device regs -> per-read dict lists through dedup/patch,
    sorted by score (mem_sort_dedup_patch output order).

    Arrays convert to nested Python lists ONCE (tolist) — per-element
    numpy scalar indexing was ~3x slower across the hot loop."""
    B = len(seq_codes)
    fields = ("rid", "qb", "qe", "rb", "re", "score", "truesc",
              "sw_w", "seedcov", "seedlen0")
    cols = {f: np.asarray(regs[f]).tolist() for f in fields}
    valid_l = np.asarray(regs["valid"]).tolist()
    frac_l = np.asarray(regs["frac_rep"]).tolist()
    is_alt_l = np.asarray(pref.is_alt).tolist()
    E = len(valid_l[0]) if B else 0
    out = []
    for b in range(B):
        vb = valid_l[b]
        rl = []
        for e in range(E):
            if not vb[e]:
                continue
            qb = cols["qb"][b][e]
            qe = cols["qe"][b][e]
            if qe <= qb:
                continue
            rid = cols["rid"][b][e]
            rl.append(dict(
                rid=rid, qb=qb, qe=qe, rb=cols["rb"][b][e],
                re=cols["re"][b][e], score=cols["score"][b][e],
                truesc=cols["truesc"][b][e], w=cols["sw_w"][b][e],
                seedcov=cols["seedcov"][b][e],
                seedlen0=cols["seedlen0"][b][e],
                frac_rep=frac_l[b],
                sub=0, csub=0, sub_n=0,
                is_alt=is_alt_l[rid] if rid >= 0 else False,
            ))
        codes = np.asarray(seq_codes[b], np.int64)
        rl = finalize.sort_dedup_patch(pref, opt, codes, rl)
        out.append(rl)
    return out
