"""The port's rank primitives and reference windows against fgdp_tpu.

Same seeded numpy inputs through both packages; integer outputs must be
exactly equal (tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fgdp_tpu.index.fmindex import FMIndex as JFMIndex
from fgdp_tpu.index.reference import DeviceReference as JDeviceReference
from fgdp_tpu.index.reference import PackedReference as JPackedReference
from fgdp_tpu.index.reference import packed_window as j_packed_window
from fgdp_tpu.ops import fm as jfm
from fgdp_tpu.ops import smem_sweep as jsweep
from fgdp_tpu_torch.index.fmindex import FMIndex
from fgdp_tpu_torch.index.reference import DeviceReference, PackedReference
from fgdp_tpu_torch.index.reference import packed_window
from fgdp_tpu_torch.ops import fm
from fgdp_tpu_torch.ops import smem_sweep

from test_torch_seeding import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def idx():
    rng = np.random.default_rng(7)
    seqs = [rng.integers(0, 4, 3000).astype(np.uint8),
            rng.integers(0, 4, 1700).astype(np.uint8)]
    seqs[1][100:110] = 4
    jpref = JPackedReference.from_contigs(["a", "b"], seqs)
    pref = PackedReference.from_contigs(["a", "b"], seqs)
    jf = JFMIndex.build(jpref.codes)
    tf = FMIndex.build(pref.codes)
    return dict(jpref=jpref, pref=pref,
                jdfm=jfm.DeviceFMIndex.from_host(jf),
                dfm=fm.DeviceFMIndex.from_host(tf, device="cpu"),
                jdref=JDeviceReference(jpref),
                dref=DeviceReference(pref, device="cpu"), N=int(jf.text_len))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


def test_rank_primitives(idx):
    rng = np.random.default_rng(1)
    N = idx["N"]
    jd, td = idx["jdfm"], idx["dfm"]
    i = rng.integers(0, N + 1, 512).astype(np.int32)
    s = rng.integers(0, 40, 512).astype(np.int32)
    k = np.minimum(i, N - s).astype(np.int32)
    l = rng.integers(0, N, 512).astype(np.int32)
    c = rng.integers(0, 4, 512).astype(np.int32)
    c1 = rng.integers(0, 4, 512).astype(np.int32)
    J = jnp.asarray
    T = torch.as_tensor
    _eq(jfm.occ4(jd, J(i)), fm.occ4(td, T(i)))
    for a, b in zip(jfm.backward_extend(jd, J(k), J(l), J(s), J(c)),
                    fm.backward_extend(td, T(k), T(l), T(s), T(c))):
        _eq(a, b)
    for a, b in zip(jfm.backward_extend2(jd, J(k), J(s), J(c), J(c1)),
                    fm.backward_extend2(td, T(k), T(s), T(c), T(c1))):
        _eq(a, b)
    for a, b in zip(jfm.forward_extend(jd, J(k), J(l), J(s), J(c)),
                    fm.forward_extend(td, T(k), T(l), T(s), T(c))):
        _eq(a, b)
    ja = jfm.forward_extend2(jd, J(k), J(l), J(s), J(c), J(c1))
    ta = fm.forward_extend2(td, T(k), T(l), T(s), T(c), T(c1))
    for a3, b3 in zip(ja, ta):
        for a, b in zip(a3, b3):
            _eq(a, b)
    for a, b in zip(jfm.init_interval(jd, J(c)), fm.init_interval(td, T(c))):
        _eq(a, b)
    big = rng.integers(-5, N + 50, 256).astype(np.int32)
    _eq(jfm.sa_lookup(jd, J(big)), fm.sa_lookup(td, T(big)))


def test_reference_windows(idx):
    rng = np.random.default_rng(2)
    jr, tr = idx["jdref"], idx["dref"]
    l2 = 2 * idx["pref"].l_pac
    pos = rng.integers(-40, l2 + 40, 400).astype(np.int32)
    J = jnp.asarray
    T = torch.as_tensor
    _eq(jr.fetch(J(pos)), tr.fetch(T(pos)))
    for rev in (False, True):
        _eq(jr.fetch_window(J(pos), 37, reverse=rev),
            tr.fetch_window(T(pos), 37, reverse=rev))
        _eq(j_packed_window(jr.codes16, l2, J(pos), 64, rev),
            packed_window(tr.codes16, l2, T(pos), 64, rev))
    mid = rng.integers(0, l2, 400).astype(np.int32)
    for a, b in zip(jr.contig_window(J(mid)), tr.contig_window(T(mid))):
        _eq(a, b)
    re = np.minimum(mid + rng.integers(0, 300, 400), l2).astype(np.int32)
    _eq(jr.intv2rid(J(mid), J(re)), tr.intv2rid(T(mid), T(re)))
    fpos = rng.integers(-3, idx["pref"].l_pac + 3, 100).astype(np.int32)
    _eq(jr.pos2rid(J(fpos)), tr.pos2rid(T(fpos)))


def test_read_windows():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, (6, 45)).astype(np.int32)
    lens = np.array([45, 30, 0, 12, 45, 44], np.int32)
    rid = rng.integers(0, 6, 50).astype(np.int32)
    start = rng.integers(-70, 60, 50).astype(np.int32)
    jp = jsweep.pack_reads(jnp.asarray(codes))
    tp = smem_sweep.pack_reads(torch.as_tensor(codes))
    _eq(jp, tp)
    for T in (16, 64):
        _eq(jsweep.read_window(jp, jnp.asarray(rid), jnp.asarray(start),
                               jnp.asarray(lens[rid]), T),
            smem_sweep.read_window(tp, torch.as_tensor(rid),
                                   torch.as_tensor(start),
                                   torch.as_tensor(lens[rid]), T))
    j = rng.integers(-3, 50, 50).astype(np.int32)
    _eq(jsweep._read_base_at(jnp.asarray(codes), jnp.asarray(rid),
                             jnp.asarray(j)),
        smem_sweep._read_base_at(torch.as_tensor(codes),
                                 torch.as_tensor(rid), torch.as_tensor(j)))
