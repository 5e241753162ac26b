"""The port's RMI learned index (index/rmi.py) and exact/inexact search
(ops/exact.py) against fgdp_tpu's, on tests/test_rmi.py's world (a
1,500 bp random reference, seed 17, leaf_bits 8).

Every array and every search output must be exactly equal (tolerance
0); rmi_interval must equal RMIndex.lookup_host, the lexicographically
largest key included (tests/test_rmi.py's overshoot case); `index`
through both CLIs writes <prefix>.rmi.npz with equal arrays."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgdp_tpu.index.fmindex import FMIndex as JFMIndex
from fgdp_tpu.index.rmi import RMIndex as JRMIndex
from fgdp_tpu.ops import exact as jexact
from fgdp_tpu.ops.fm import DeviceFMIndex as JDeviceFMIndex
from fgdp_tpu.utils import dna as jdna
from fgdp_tpu_torch.index.fmindex import FMIndex
from fgdp_tpu_torch.index.rmi import RMIndex, pack_pattern
from fgdp_tpu_torch.ops import exact
from fgdp_tpu_torch.ops.fm import DeviceFMIndex

from test_torch_seeding import HERE, one_torch_thread  # noqa: F401

K = 13
RMI_FIELDS = ("keys", "slope", "intercept", "err_lo", "err_hi", "starts")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    ref = rng.integers(0, 4, 1500).astype(np.uint8)
    x = np.concatenate([ref, jdna.revcomp(ref)]).astype(np.uint8)
    jf, tf = JFMIndex.build(ref), FMIndex.build(ref)
    jr = JRMIndex.build(x, jf.sa, leaf_bits=8)
    tr = RMIndex.build(x, tf.sa, leaf_bits=8)
    j = dict(fm=jf, rmi=jr, dfm=JDeviceFMIndex.from_host(jf),
             drmi=jexact.DeviceRMI.from_host(jr))
    t = dict(fm=tf, rmi=tr, dfm=DeviceFMIndex.from_host(tf, device="cpu"),
             drmi=exact.DeviceRMI.from_host(tr, device="cpu"))
    return rng, x, j, t


def test_rmi_arrays_equal(world):
    _, _, j, t = world
    for f in RMI_FIELDS:
        a, b = getattr(j["rmi"], f), getattr(t["rmi"], f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (j["rmi"].shift, j["rmi"].k) == (t["rmi"].shift, t["rmi"].k)


def test_rmi_interval_equals_lookup_host(world):
    """Present, random and extreme keys, among them the largest key
    twice (its q+1 probe must converge to N exactly)."""
    rng, x, j, t = world
    pos = rng.integers(0, len(x) - K, 64)
    pats = np.stack([x[p:p + K] for p in pos]).astype(np.int32)
    pats[::5] = rng.integers(0, 4, (len(pats[::5]), K))
    keys = [pack_pattern(p) for p in pats]
    r = t["rmi"]
    keys += [int(r.keys[-1])] * 2 + [int(r.keys[0]), 0, 1,
                                     int(r.keys[len(r.keys) // 2])]
    q = np.asarray(keys, np.int32)
    tk, ts = exact.rmi_interval(t["drmi"], torch.as_tensor(q))
    jk, js = jax.jit(jexact.rmi_interval)(j["drmi"], jnp.asarray(q))
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    for i, qk in enumerate(keys):
        lo, s = r.lookup_host(qk)
        assert int(ts[i]) == s and (s == 0 or int(tk[i]) == lo), i
    # the pattern packing of the device matches the host's
    pk, ok = exact.pack_patterns(torch.as_tensor(pats),
                                 torch.zeros(len(pats), dtype=torch.int32),
                                 K)
    assert pk.tolist() == keys[:len(pats)] and bool(ok.all())


def search_reads(rng, x, B, L):
    """tests/test_rmi.py's exact-search mix: planted, mutated, short
    (below the RMI chunk, and empty) and ambiguous patterns."""
    reads = np.zeros((B, L), np.int32)
    lens = np.full(B, L, np.int32)
    for i in range(B):
        p = int(rng.integers(0, len(x) - L))
        reads[i] = x[p:p + L]
        kind = i % 4
        if kind == 1:
            reads[i, L // 2] = (reads[i, L // 2] + 1) % 4
        elif kind == 2:
            lens[i] = int(rng.integers(0, K + 2))
        elif kind == 3:
            reads[i, int(rng.integers(0, L))] = 4
    return reads, lens


def test_exact_search_equal_jax(world):
    rng, x, j, t = world
    reads, lens = search_reads(rng, x, 32, 41)
    jk, js = jax.jit(jexact.exact_search)(j["dfm"], j["drmi"],
                                          jnp.asarray(reads),
                                          jnp.asarray(lens))
    tk, ts = exact.exact_search(t["dfm"], t["drmi"],
                                torch.as_tensor(reads),
                                torch.as_tensor(lens))
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert int((ts > 0).sum()) >= 8


@pytest.mark.parametrize("z,L,max_out,fifo_cap", [
    (1, 17, 64, None), (2, 9, 4, None), (0, 12, 8, None), (1, 17, 64, 9),
    (1, 17, 64, 16), (2, 9, 64, 60)])
def test_inexact_search_equal_jax(world, z, L, max_out, fifo_cap):
    """Up to z mismatches; max_out 4 overflows the output buffer, the
    small rings (fifo_cap) overflow the FIFO."""
    rng, x, j, t = world
    B = 16
    reads = np.zeros((B, L), np.int32)
    for i in range(B):
        r = x[(p := int(rng.integers(0, len(x) - L))):p + L].copy()
        if i % 2:
            r[int(rng.integers(0, L))] = (r[int(rng.integers(0, L))] + 1) % 4
        reads[i] = r
    lens = np.full(B, L, np.int32)
    fn = jax.jit(jexact.inexact_search,
                 static_argnames=("z", "max_out", "fifo_cap"))
    jo = fn(j["dfm"], jnp.asarray(reads), jnp.asarray(lens), z=z,
            max_out=max_out, fifo_cap=fifo_cap)
    to = exact.inexact_search(t["dfm"], torch.as_tensor(reads),
                              torch.as_tensor(lens), z=z, max_out=max_out,
                              fifo_cap=fifo_cap)
    for name, a, b in zip(("k", "s", "count", "overflow"), jo, to):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
    assert int(to[2].sum()) > 0
    if max_out == 4 or fifo_cap in (9, 60):
        assert bool(to[3].any())


def test_index_writes_rmi_equal(tmp_path):
    """`index` of both CLIs on tests/golden/ref.fa: .rmi.npz arrays equal
    (the port's is read back through its own RMIndex.load)."""
    from fgdp_tpu import cli as jcli
    from fgdp_tpu_torch import cli

    fa = os.path.join(HERE, "ref.fa")
    jcli.main(["index", fa, str(tmp_path / "j")])
    cli.main(["index", fa, str(tmp_path / "t")])
    jr = JRMIndex.load(str(tmp_path / "j.rmi"))
    tr = RMIndex.load(str(tmp_path / "t.rmi"))
    for f in RMI_FIELDS:
        np.testing.assert_array_equal(getattr(jr, f), getattr(tr, f),
                                      err_msg=f)
    assert (jr.shift, jr.k) == (tr.shift, tr.k)
    assert len(tr.keys) == len(FMIndex.load(str(tmp_path / "t.fmi")).sa)
