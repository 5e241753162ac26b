"""CNN pre-filter ("deep" mutect gate, reference M13).

The reference runs a TorchScript transformer (trans.pt, 1.1 MB) over a
5x6x31 pileup-feature tensor per candidate variant and skips calling in
regions the classifier deems germline/noise (deepmutect .../src/model/
model.cpp:409-531; gate at main.cpp:213-221). It fires only for dense
regions (>100 reads).

Feature builder transcribes model::generateData (model.cpp:10-393)
including the insertion padding: a 31-slot max-insertion-length profile
over ALL region reads left-pads every column, reads/ref are rasterized
into the padded coordinate space (gap row 5 fills pads; an insertion's
own bases land in its pads), and the final 31 columns are re-cut at
matricStart = sum(insertion[0..15]) so the variant stays at column 15.
The per-variant scan order + padded-window skip (position/regionEnd,
model.cpp:435-467) is reproduced by gate_inputs.

Port of the JAX package's call/cnn_filter.py. The feature builder is
host numpy and runs wherever the region is prepared (the engine's region
workers included, which never touch the card); the forward runs on the
filter's device, the CUDA card unless the caller asks for the CPU, one
batched forward per region over every variant the scan classifies.
The skip window depends only on the insertion profile, never on a
decision, so the region is kept when ANY of those variants classifies
somatic, the same decision as the reference's early exit.

Known reference quirks preserved: M/D column loops run to vcEnd
EXCLUSIVE (the 31st column carries no read counts), the insertion
profile scan is vcStart..vcEnd INCLUSIVE, and an I element at exactly
vcStart contributes padding but no bases (readStart > vcStart strict,
model.cpp:226).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

# model.cpp:516-521; compared in float64 with the model's output, so a
# float32 output passes only at exactly 1.0
THRESHOLD = 0.9999999995

# cigar op codes used by the caller's read dicts
_M_OPS = (0, 7, 8)            # M, EQ, X
_REF_ADV = (0, 2, 3, 7, 8)    # M, D, N, EQ, X


def _cigar_ref_len(cigar):
    return sum(ln for op, ln in cigar if op in _REF_ADV)


def _lead_soft(cigar):
    return cigar[0][1] if cigar and cigar[0][0] == 4 else 0


def insertion_profile(reads, vc_start, vc_end):
    """max I-length per column over ALL reads (model.cpp:15-40)."""
    ins = np.zeros(31, np.int64)
    for rd in reads:
        rs = rd["pos"]
        for op, ln in rd["cigar"]:
            if op in _REF_ADV:
                rs += ln
            elif op == 1:
                if vc_start <= rs <= vc_end:
                    idx = rs - vc_start
                    if ln > ins[idx]:
                        ins[idx] = ln
    return ins


def _rasterize_reads(reads, ins, vc_start, vc_end, pad_len, out):
    """model.cpp:157-262 (case) == :264-368 (normal): one read's bases
    into the padded coordinate space; `out` is the [6, pad_len] plane."""
    for rd in reads:
        it_ins = ins.copy()
        rs = rd["pos"]
        re = rs + _cigar_ref_len(rd["cigar"]) - 1
        bp = _lead_soft(rd["cigar"])          # readStart - softStart
        op_out = 0
        if vc_start < rs:
            for i in range(min(rs - vc_start, 31)):
                op_out += int(it_ins[i]) + 1
        seq = rd["seq_codes"]
        for op, ln in rd["cigar"]:
            if rs > min(re, vc_end):
                break
            if op == 2 or op == 3:            # D / N
                if rs + ln > vc_start:
                    for i in range(max(vc_start, rs),
                                   min(rs + ln, vc_end)):
                        ii = int(it_ins[i - vc_start])
                        for k in range(ii + 1):
                            out[5, op_out + k] += 1
                        op_out += ii + 1
                rs += ln
            elif op in _M_OPS:
                if rs + ln > vc_start:
                    if vc_start > rs:
                        bp += vc_start - rs
                    for i in range(max(vc_start, rs),
                                   min(rs + ln, vc_end)):
                        ii = int(it_ins[i - vc_start])
                        for k in range(ii):
                            out[5, op_out + k] += 1
                        op_out += ii
                        b = int(seq[bp]) if 0 <= bp < len(seq) else 4
                        out[min(b, 4), op_out] += 1
                        bp += 1
                        op_out += 1
                    rs += ln
                else:
                    rs += ln
                    bp += ln
            elif op == 1:                     # I
                if rs > vc_start:
                    for _ in range(ln):
                        b = int(seq[bp]) if 0 <= bp < len(seq) else 4
                        out[min(b, 4), op_out] += 1
                        bp += 1
                        op_out += 1
                    for _ in range(ln, int(it_ins[rs - vc_start])):
                        out[5, op_out] += 1
                        op_out += 1
                    it_ins[rs - vc_start] = 0
                else:
                    bp += ln
            # S / H / P: no ref advance, bases pre-accounted via bp


def generate_data(ref_codes, case_reads, normal_reads, all_reads,
                  vc_start, vc_end):
    """model::generateData — returns (result[3][6][31], insertion[31])."""
    ins = insertion_profile(all_reads, vc_start, vc_end)
    pad_len = 31 + int(ins.sum())
    pad = np.zeros((3, 6, pad_len), np.int64)

    # reference row (model.cpp:53-156): one base per column, pads first
    rp = vc_start
    op_out = 0
    for i in range(31):
        ii = int(ins[i])
        if ii:
            for k in range(ii):
                pad[0, 5, op_out + k] += 1
            op_out += ii
        b = int(ref_codes[rp]) if 0 <= rp < len(ref_codes) else 4
        pad[0, min(b, 4), op_out] += 1
        rp += 1
        op_out += 1

    _rasterize_reads(case_reads, ins, vc_start, vc_end, pad_len, pad[1])
    _rasterize_reads(normal_reads, ins, vc_start, vc_end, pad_len, pad[2])

    start = int(ins[:16].sum())               # matricStart
    return pad[:, :, start:start + 31], ins


def features(ref_codes, tumor_reads, normal_reads, vc_pos):
    """inputs[5][6][31] (model.cpp:468-499). Reads overlapping the
    window are selected here (readTrim, model.cpp:396-405). Returns
    (inputs, insertion profile, vc_start)."""
    vc_start = vc_pos - 15
    vc_end = vc_pos + 15
    if vc_start < 0:
        vc_start, vc_end = 0, 30

    def trim(reads):
        return [rd for rd in reads
                if not (rd["pos"] + _cigar_ref_len(rd["cigar"]) - 1
                        < vc_start or rd["pos"] > vc_end)]

    res, ins = generate_data(ref_codes, trim(tumor_reads),
                             trim(normal_reads),
                             list(tumor_reads) + list(normal_reads),
                             vc_start, vc_end)
    inputs = np.zeros((5, 6, 31), np.float32)
    inputs[0] = res[0]
    depth = res[1:3].sum(axis=1).astype(np.float32)   # [2, 31]
    inputs[1] = res[1] / (depth[0] + 1e-11)
    inputs[2] = res[2] / (depth[1] + 1e-11)
    both = (res[1] + res[2]).astype(np.float32)
    inputs[3] = res[1] / (both + 1e-11)
    inputs[4] = res[2] / (both + 1e-11)
    return inputs, ins, vc_start


def gate_inputs(ref_codes, tumor_reads, normal_reads, events):
    """modelRefer's scan (model.cpp:409-500) without the model: variants
    in position order, each classified unless inside the previous
    classified variant's padded window. Returns (float32[V, 5, 6, 31],
    the V positions classified)."""
    position = 0
    rows, at = [], []
    for pos in sorted(events):
        if position > pos:                    # vc end ~ pos for SNVs
            continue
        inputs, ins, vc_start = features(ref_codes, tumor_reads,
                                         normal_reads, pos)
        count2, index2 = 15, 15
        while count2 < 30:
            count2 += int(ins[index2 + 1]) + 1
            index2 += 1
        if index2 == 29:
            index2 += 1
        position = vc_start + index2
        rows.append(inputs)
        at.append(pos)
    if not rows:
        return np.zeros((0, 5, 6, 31), np.float32), at
    return np.stack(rows), at


class CnnFilter:
    """The TorchScript gate (trans.pt) on `device`: the CUDA card when
    None (raises without one), the CPU only when asked."""

    features = staticmethod(features)

    def __init__(self, model_path, device=None):
        self.device = resolve_device(device)
        self.model = torch.jit.load(model_path, map_location=self.device)
        self.model.eval()

    def scores(self, inputs) -> np.ndarray:
        """out[:, 0] of one forward over inputs float32[V, 5, 6, 31]
        (each row laid out as model.cpp:500-515 feeds it: [30, 31],
        transposed), widened to float64."""
        x = np.ascontiguousarray(inputs, np.float32).reshape(-1, 30, 31)
        t = torch.from_numpy(x).to(self.device).transpose(1, 2)
        with torch.no_grad():
            out = self.model(t)
        return out[:, 0].double().cpu().numpy()

    def classify(self, inputs) -> bool:
        """One variant's inputs[5][6][31]: True => confident somatic, the
        polarity of model.cpp:516-527's `classify`."""
        return bool(passes(self.scores(inputs[None]))[0])

    def keep(self, inputs) -> bool:
        """A region's decision from its gate_inputs rows: keep when any
        row classifies somatic."""
        return bool(len(inputs)) and bool(passes(self.scores(inputs)).any())

    def gate_region(self, ref_codes, tumor_reads, normal_reads,
                    events) -> bool:
        """modelRefer: True = KEEP the region (the engine skips the region
        when this returns False, matching `if (!modelRefer) return {}`,
        Mutect2Engine.cpp:216-221)."""
        return self.keep(gate_inputs(ref_codes, tumor_reads, normal_reads,
                                     events)[0])


def passes(scores) -> np.ndarray:
    """Per-row decision: the output, widened to float64, above THRESHOLD
    (model.cpp:516-521)."""
    return np.asarray(scores, np.float64) > THRESHOLD
