"""Instruction counts of the built kernels' loops, from their SASS.

    python -m fgdp_tpu_torch.probes.sass

runs `cuobjdump -sass` (CUDA toolkit) on the kernel libraries under
build/fgdp_tpu_torch/ (building them first) and prints, for the SW and
PairHMM kernels' row loops and the kswv wavefront's step loop at every
K, the chain loop's step loop at every K and the INT32 issue probe's
step loop,
the SASS instructions of the loop body and the most frequent opcodes.
A loop is the span from a backward branch's target to the branch; the
outermost (largest) loop of a kernel's main body is taken, and
everything in it is counted, rarely taken blocks included. Needs the
toolkit, not the card.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess

from ..ops import kernels

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_RES_FN = re.compile(r"\bFunction\s+([^\s:]+)\s*:")
_STACK = re.compile(r"\bSTACK:(\d+)")
_BRA = re.compile(r"\bBRA(?:\.\w+)*\s+(?:(0x[0-9a-f]+)|`\((\.L_x_\d+)\))")


def _cuobjdump():
    path = shutil.which("cuobjdump")
    if path is None and os.path.exists("/usr/local/cuda/bin/cuobjdump"):
        path = "/usr/local/cuda/bin/cuobjdump"
    if path is None:
        raise RuntimeError("cuobjdump not found: it comes with the CUDA "
                           "toolkit")
    return path


def functions(so):
    """parse() of a library's `cuobjdump -sass` listing."""
    return parse(subprocess.run([_cuobjdump(), "-sass", so],
                                capture_output=True, text=True, timeout=300,
                                check=True).stdout)


def stack_frames(lib):
    """{mangled kernel name: stack frame bytes} of the built library
    `lib`, from `cuobjdump -res-usage` (whenever the library was built)."""
    return parse_res_usage(subprocess.run(
        [_cuobjdump(), "-res-usage", kernels._so(lib)], capture_output=True,
        text=True, timeout=300, check=True).stdout)


def parse_res_usage(listing):
    """{function: largest STACK:n} of a `cuobjdump -res-usage` listing."""
    out, cur = {}, None
    for ln in listing.splitlines():
        m = _RES_FN.search(ln)
        if m:
            cur = m.group(1)
        m = _STACK.search(ln)
        if m and cur is not None:
            out[cur] = max(out.get(cur, 0), int(m.group(1)))
    return out


def parse(listing):
    """{mangled kernel name: [(address, instruction text)]} of a SASS
    listing, and each function's labels {label: address}."""
    funcs, labels, cur, pending = {}, {}, None, []
    for ln in listing.splitlines():
        m = _FUNC.search(ln)
        if m:
            cur = m.group(1)
            funcs[cur], labels[cur], pending = [], {}, []
            continue
        if cur is None:
            continue
        m = _LABEL.match(ln)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(ln)
        if m:
            addr = int(m.group(1), 16)
            for lb in pending:
                labels[cur][lb] = addr
            pending = []
            funcs[cur].append((addr, m.group(2)))
    return funcs, labels


def opcode(text):
    """The instruction's opcode without its predicate and modifiers."""
    tok = text.split()
    if tok and tok[0].startswith("@"):
        tok = tok[1:]
    return tok[0].split(".")[0] if tok else ""


def outer_loop(instrs, labels):
    """(instruction count, Counter of opcodes) of the largest span from a
    backward branch's target to the branch, NOPs left out; None when the
    function has no backward branch. Only branches before the first
    unpredicated EXIT count: after it the compiler places the slow paths
    of warp-wide operations for a warp that is not converged (BRA.DIV
    targets), which branch back into the loop but never run here."""
    end = next((a for a, t in instrs if t.split()[:1] == ["EXIT"]), None)
    best = None
    for addr, text in instrs:
        if end is not None and addr > end:
            break
        m = _BRA.search(text)
        if not m:
            continue
        target = int(m.group(1), 16) if m.group(1) else \
            labels.get(m.group(2))
        if target is None or target > addr:
            continue
        body = [opcode(t) for a, t in instrs if target <= a <= addr]
        body = [o for o in body if o != "NOP"]
        if best is None or len(body) > len(best):
            best = body
    if best is None:
        return None
    return len(best), collections.Counter(best)


def last_loop(instrs, labels):
    """outer_loop's count for the last innermost loop of the function
    that holds a shuffle (the span of a backward branch with no other
    inside it, the highest in address order): a kernel's step loop that
    follows a loop of its first steps, inside a loop over chunks, before
    loops that only store."""
    end = next((a for a, t in instrs if t.split()[:1] == ["EXIT"]), None)
    spans = []
    for addr, text in instrs:
        if end is not None and addr > end:
            break
        m = _BRA.search(text)
        if not m:
            continue
        target = int(m.group(1), 16) if m.group(1) else \
            labels.get(m.group(2))
        if target is not None and target <= addr:
            spans.append((target, addr))
    inner = [sp for sp in spans if not any(o != sp and sp[0] <= o[0] and
                                           o[1] <= sp[1] for o in spans)]
    bodies = [[o for o in (opcode(t) for a, t in instrs if lo <= a <= hi)
               if o != "NOP"] for lo, hi in sorted(inner)]
    bodies = [b for b in bodies if "SHFL" in b]
    if not bodies:
        return None
    return len(bodies[-1]), collections.Counter(bodies[-1])


def template_loops(lib, kernel, loop=None):
    """{N: (instructions, opcodes)} of the outer loop (or `loop`'s) of
    every instantiation kernel<N> in the kernel library `lib`."""
    funcs, labels = functions(kernels._so(lib))
    out = {}
    for name, instrs in funcs.items():
        m = re.search(kernel + r"ILi(\d+)E", name)
        if m:
            out[int(m.group(1))] = (loop or outer_loop)(instrs, labels[name])
    return out


def sw_row_loops():
    """{K: (instructions, opcodes)} of the SW kernel's row loop."""
    return template_loops("sw_extend", "sw_extend_kernel")


def pairhmm_row_loops():
    """{K: (instructions, opcodes)} of the PairHMM register kernel's row
    loop (the next chunk's input loads and the doublings a launch skips
    included)."""
    return template_loops("pairhmm", "pairhmm_regs_kernel")


def kswv_row_loops():
    """{K: (instructions, opcodes)} of the kswv register kernel's step
    loop: the wavefront's main steps (one step a pass, the decision and
    its rarely taken best-row copy included), after the loop of its first
    32 steps and inside the loop over chunks."""
    return template_loops("kswv", "kswv_regs_kernel", last_loop)


def chain_step_loops():
    """{K: (instructions, opcodes)} of the chain loop's register kernel's
    step loop (the next chunk's loads and the chain-id stores of a chunk
    change included)."""
    return template_loops("chain_loop", "chain_regs_kernel")


def int32_step_loops():
    """{chains: (instructions, opcodes)} of the INT32 probe's step loop."""
    return template_loops("vpu_ceiling", "vpu_int32_kernel")


def _show(label, loop, per=None):
    n, ops = loop
    top = ", ".join(f"{o} {c}" for o, c in ops.most_common(12))
    extra = f" = {n / per[1]:.2f} per {per[0]}" if per else ""
    print(f"{label}: {n} instructions{extra}; {top}", flush=True)


def main():
    kernels.build(("sw_extend", "kswv", "pairhmm", "chain_loop",
                   "vpu_ceiling"))
    for k, loop in sorted(sw_row_loops().items()):
        if loop is not None:
            _show(f"sw_extend K={k} row loop (32 lanes x {k} columns)",
                  loop, ("column a lane holds", k))
    for k, loop in sorted(kswv_row_loops().items()):
        if loop is not None:
            _show(f"kswv K={k} step loop (32 lanes x {k} columns)",
                  loop, ("column a lane holds", k))
    for k, loop in sorted(pairhmm_row_loops().items()):
        if loop is not None:
            _show(f"pairhmm K={k} row loop (32 lanes x {k} columns)",
                  loop, ("column a lane holds", k))
    for k, loop in sorted(chain_step_loops().items()):
        if loop is not None:
            _show(f"chain_loop K={k} step loop (32 lanes x {k} chain "
                  f"slots)", loop, ("slot a lane holds", k))
    from .vpu_ceiling import INT_OPS_PER_ROUND, N_FMA
    for nch, loop in sorted(int32_step_loops().items()):
        if loop is not None:
            # the ops the probe's INT32 rate counts per step: the rounds'
            # add, subtract and max (not the chains' xors and sum)
            src = INT_OPS_PER_ROUND * N_FMA
            _show(f"vpu_int32 chains={nch} step loop ({src} counted ops "
                  f"+ {2 * nch - 1} for the chains)", loop,
                  ("counted op", src))


if __name__ == "__main__":
    main()
