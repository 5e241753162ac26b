"""The port's multi-process layer (parallel/distributed.py, mesh.py,
sortdup_sharded.py) on torch.distributed with gloo, on the CPU.

Each run is world-size many subprocesses of this file (`--worker`),
rendezvousing through a file store under the test's tmp_path (no fixed
port, so xdist workers never collide), one torch thread each, with a
timeout. One run per world size (1, 2, 4) does every job, and the tests
read what it wrote:
  * world size 2 repeats tests/test_distributed_multiproc.py's checks:
    the rank, a global mesh, per-rank batches assembled into the global
    one, and a cross-process reduction;
  * sharded duplicate flags and coordinate order against the port's
    single-device engine and against fgdp_tpu.parallel.sortdup_sharded
    on its 8-device CPU mesh, on tests/test_sortdup_sharded.py's inputs;
  * a small capacity raises the overflow flag on every rank;
  * world size 2: data-parallel shard_align_fn gives the regs of one
    process over the whole batch;
  * world sizes 2 (dp 1 x fm 2) and 4 (dp 2 x fm 2): on the index
    range-sharded over "fm" (mesh.shard_index), occ4 and sa_lookup equal
    the unsharded ones on random rows, the padded tail and both clip
    edges, and shard_align_fn_2d's packed regs equal one process's
    device_align on the unsharded index over each dp row block of
    tests/golden/rep.fq, at caps where most reads overflow, at a rung
    of the escalation ladder, and on the sweep.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).parents[1]
WORLDS = (1, 2, 4)
ND, NS, N_SORT = 256, 128, 512
ALIGN_READS = 64
# (caps, engine) of the 2-D mesh's align runs: the ladder test's tight
# caps (every read overflows), the k2w rung of level 1, and the sweep
MESH2D_RUNS = (("tight", "lcp"), ("k2w1", "lcp"), ("tight", "sweep"))


def _mesh2d_jobs(world):
    """The index-sharding half of parallel/mesh.py on this rank."""
    import dataclasses
    import functools

    import torch

    from fgdp_tpu_torch.config import BatchShapes
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.io.fastq import parse_fastq_records
    from fgdp_tpu_torch.ops import fm as fmops
    from fgdp_tpu_torch.parallel import mesh as M
    from fgdp_tpu_torch.pipeline import (Aligner, device_align_packed,
                                         unpack_regs)
    from fgdp_tpu_torch.utils import dna

    res = {}
    golden = ROOT / "tests" / "golden"
    pref = PackedReference.from_fasta(str(golden / "rep_ref.fa"))
    tight = BatchShapes(read_len=100, batch_reads=ALIGN_READS, max_smems=1,
                        max_seeds=8, max_chains=2, max_regs=3,
                        transfer_regs=2, pack_cap=1, max_ext_ref=304)
    al = Aligner(pref, FMIndex.build(pref.codes), shapes=tight,
                 device="cpu")
    mesh = M.make_mesh_2d(fm_ways=2, device="cpu")
    assert tuple(mesh.shape) == (world // 2, 2)
    sharded = M.shard_index(mesh, al.dfm)
    dfm = al.dfm

    # rank primitives on random rows, the padded tail and the clip edges
    n_sa = dfm.sa.shape[0]
    n_occ = 32 * dfm.occ_fused.shape[0]
    rng = np.random.default_rng(5)
    edges = [-40, -1, 0, 1, n_sa - 1, n_sa, n_sa + 1, n_occ - 1, n_occ,
             n_occ + 31, n_occ + 64, 2**31 - 1]
    rows = torch.as_tensor(np.concatenate(
        [edges, rng.integers(0, n_sa, 200)]).astype(np.int32))
    for name, fn in (("occ4", fmops.occ4), ("sa", fmops.sa_lookup)):
        res[f"mesh2d_{name}_whole"] = fn(dfm, rows).numpy()
        res[f"mesh2d_{name}_sharded"] = fn(sharded, rows).numpy()

    seqs = [dna.encode(r[2]) for r in parse_fastq_records(
        str(golden / "rep.fq"))][:ALIGN_READS]
    L = tight.read_len
    codes = np.full((len(seqs), L), 4, np.int32)
    lens = np.zeros(len(seqs), np.int32)
    for i, q in enumerate(seqs):
        codes[i, :min(len(q), L)] = q[:L]
        lens[i] = min(len(q), L)
    active = np.ones(len(seqs), bool)
    caps = {"tight": tight,
            "k2w1": dataclasses.replace(al._k2_wide_shapes(1),
                                        batch_reads=ALIGN_READS)}
    for cap, engine in MESH2D_RUNS:
        tree = dict(lcp_tree=al.lcp_tree, lcp_isa=al.lcp_isa) \
            if engine == "lcp" else {}
        fn = functools.partial(device_align_packed, opt=al._dev_opt,
                               shapes=caps[cap], **tree)
        run = M.shard_align_fn_2d(fn, mesh)
        got = M.gathered_regs(run(sharded, al.dref, codes, lens, active))
        # one process over each dp row block (the ranks of a dp row
        # run their rows as their own batch, as shard_align_fn does)
        n = len(seqs) // (world // 2)
        parts = [unpack_regs(fn(dfm, al.dref, *(
            torch.as_tensor(a[d:d + n]) for a in (codes, lens, active)))
            .numpy()) for d in range(0, len(seqs), n)]
        whole = {k: np.concatenate([q[k] for q in parts])
                 for k in parts[0]}
        for k in whole:
            res[f"mesh2d_{cap}_{engine}_whole_{k}"] = whole[k]
            res[f"mesh2d_{cap}_{engine}_got_{k}"] = got[k]
    return res


# ---------------------------------------------------------------- worker

def _worker(rank, world, store, inp, out):
    import functools

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from fgdp_tpu_torch.parallel import distributed as D
    from fgdp_tpu_torch.parallel import sortdup_sharded as shd

    init = "file://" + store
    if world == 1:                   # initialize() is a no-op there
        assert D.initialize(init, 1, 0, device="cpu") == 0
        dist.init_process_group(D.backend_for("cpu"), init_method=init,
                                world_size=1, rank=0)
    else:
        assert D.initialize(init, world, rank, device="cpu") == rank
    assert dist.get_backend() == "gloo" and dist.get_world_size() == world
    res = {}

    # tests/test_distributed_multiproc.py's checks
    mesh = D.global_mesh({"dp": world}, device="cpu")
    local = torch.arange(16, dtype=torch.int32).reshape(8, 2) + 1000 * rank
    g = D.host_local_batch_to_global(mesh, local)
    assert g.shape == (8 * world, 2)
    want = sum(int((np.arange(16) + 1000 * q).sum()) for q in range(world))
    total = int(g.gather().sum())
    s = local.sum().to(torch.int64)
    dist.all_reduce(s)
    assert total == want == int(s), (total, int(s), want)
    assert g.gather()[8 * rank:8 * rank + 8].equal(local)
    m2 = D.global_mesh({"dp": 2 if world > 1 else 1, "sp": -1},
                       device="cpu")
    res["mesh_shape"] = np.asarray(m2.shape)

    # sharded duplicate marking and sort on this rank's rows
    d = dict(np.load(inp))
    sp = D.global_mesh({"sp": world}, device="cpu")

    def rows(a):
        n = len(a) // world
        return torch.as_tensor(a[rank * n:(rank + 1) * n])

    args = {k: rows(v) for k, v in d.items() if k.startswith(("dbl_",
                                                                 "sgl_"))}
    args["ref_len"] = int(d["ref_len"])
    dd, ds, ovf = shd.sharded_mark_duplicates(sp, args,
                                              2 * int(d["ref_len"]))
    res.update(dup_dbl=dd.numpy(), dup_sgl=ds.numpy(), ovf=ovf)
    order, ovf = shd.sharded_coordinate_sort(
        sp, rows(d["uc"]), rows(d["valid"]), int(d["total"]))
    res.update(order=order.numpy(), sort_ovf=ovf)
    # every double in one small range: one rank owns them all
    args["dbl_p5a"] = rows(d["dbl_p5a"] % 100)
    res["small_cap_ovf"] = shd.sharded_mark_duplicates(
        sp, args, 2 * int(d["ref_len"]), per_dest_cap=4)[2]

    if world == 2:
        from fgdp_tpu_torch.index.fmindex import FMIndex
        from fgdp_tpu_torch.index.reference import PackedReference
        from fgdp_tpu_torch.io.fastq import parse_fastq_records
        from fgdp_tpu_torch.config import BatchShapes
        from fgdp_tpu_torch.parallel import mesh as M
        from fgdp_tpu_torch.pipeline import (Aligner, device_align_packed,
                                             unpack_regs)
        from fgdp_tpu_torch.utils import dna

        golden = ROOT / "tests" / "golden"
        pref = PackedReference.from_fasta(str(golden / "ref.fa"))
        al = Aligner(pref, FMIndex.build(pref.codes),
                     shapes=BatchShapes(read_len=100), device="cpu")
        L = al.shapes.read_len
        seqs = [dna.encode(r[2]) for r in parse_fastq_records(
            str(golden / "se.fq"))][:ALIGN_READS]
        codes = np.full((len(seqs), L), 4, np.int32)
        lens = np.zeros(len(seqs), np.int32)
        for i, q in enumerate(seqs):
            codes[i, :min(len(q), L)] = q[:L]
            lens[i] = min(len(q), L)
        active = np.ones(len(seqs), bool)
        fn = functools.partial(device_align_packed, opt=al._dev_opt,
                               shapes=al.shapes, lcp_tree=al.lcp_tree,
                               lcp_isa=al.lcp_isa)
        dp = M.make_mesh(2, device="cpu")
        dfm, dref = M.replicate(dp, (al.dfm, al.dref))
        run = M.shard_align_fn(fn, dp)
        got = M.gathered_regs(run(dfm, dref, codes, lens, active))
        whole = unpack_regs(fn(dfm, dref, *(torch.as_tensor(a) for a in
                                            (codes, lens, active))).numpy())
        for k in whole:
            res[f"align_whole_{k}"] = whole[k]
            res[f"align_dp_{k}"] = got[k]
    if world in (2, 4):
        res.update(_mesh2d_jobs(world))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
    print(f"WORKER_OK {rank}", flush=True)


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "--worker":
    _worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    sys.exit(0)


# ---------------------------------------------------------------- tests

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fgdp_tpu.parallel import sortdup_sharded as jshd  # noqa: E402
from fgdp_tpu.sortdup import engine as jengine  # noqa: E402
from fgdp_tpu_torch.parallel import distributed as D  # noqa: E402
from fgdp_tpu_torch.sortdup import engine  # noqa: E402

from test_sortdup_sharded import _mk_args  # noqa: E402
from test_torch_seeding import ONE_THREAD_ENV, one_torch_thread  # noqa: E402,F401


def _join64(hi, lo):
    return (np.asarray(hi, np.int64) << jengine._LO_BITS) | \
        np.asarray(lo, np.int64)


def _split(x):
    x = np.asarray(x, np.int64)
    return (x >> jengine._LO_BITS).astype(np.int32), \
        (x & jengine._LO_MASK).astype(np.int32)


@pytest.fixture(scope="module")
def inputs():
    """tests/test_sortdup_sharded.py's markdup (_mk_args, seed 42, at a
    reference length whose coordinates fit the JAX package's int32
    arrays, with every 7th pair's second end copied too, so doubles
    duplicate) and sort (seed 7) inputs, as the port's int64 keys and as
    the JAX package's (hi, lo) arrays."""
    jargs, ref_len = _mk_args(np.random.default_rng(42), nd=ND, ns=NS,
                              ref_len=1 << 30)
    p5b = _join64(jargs["dbl_p5b_hi"], jargs["dbl_p5b_lo"])
    p5b[1::7] = p5b[0::7][:len(p5b[1::7])]
    jargs["dbl_p5b_hi"], jargs["dbl_p5b_lo"] = \
        (jnp.asarray(a) for a in _split(p5b))
    d = {"ref_len": _join64(jargs["ref_len_hi"], jargs["ref_len_lo"])}
    assert d["ref_len"] == ref_len
    for k, v in jargs.items():
        if k.endswith("_hi") and not k.startswith("ref_len"):
            d[k[:-3]] = _join64(v, jargs[k[:-3] + "_lo"])
        elif not k.endswith("_lo") and not k.startswith("ref_len"):
            d[k] = np.asarray(v)
    rng = np.random.default_rng(7)
    total = np.int64(1 << 40)
    uc = rng.integers(0, total, N_SORT).astype(np.int64)
    uc[5] = uc[10]                         # ties
    d.update(uc=uc, valid=rng.random(N_SORT) < 0.9, total=total)
    return d, jargs


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """{world: [per-rank result dicts]} from one gloo run per world size,
    all started at once."""
    base = tmp_path_factory.mktemp("gloo")
    inp = base / "inputs.npz"
    np.savez(inp, **inputs[0])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(ONE_THREAD_ENV)
    procs = {}
    for world in WORLDS:
        d = base / f"w{world}"
        d.mkdir()
        procs[world] = [subprocess.Popen(
            [sys.executable, __file__, "--worker", str(rank), str(world),
             str(d / "store"), str(inp), str(d)],
            env=env, cwd=str(d), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for rank in range(world)]
    out = {}
    try:
        for world, ps in procs.items():
            for rank, p in enumerate(ps):
                o, e = p.communicate(timeout=240)
                assert p.returncode == 0 and f"WORKER_OK {rank}" in o, \
                    (world, rank, e[-3000:])
            out[world] = [dict(np.load(base / f"w{world}" / f"rank{r}.npz"))
                          for r in range(world)]
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    return out


def test_initialize_single_process_noop():
    assert D.initialize() == 0
    assert D.initialize(num_processes=1) == 0
    assert not torch.distributed.is_initialized()
    assert D.backend_for("cpu") == "gloo"


def test_two_process_distributed(runs):
    """tests/test_distributed_multiproc.py's checks ran in each of the two
    ranks (asserted there); here the meshes' shapes."""
    assert [r["mesh_shape"].tolist() for r in runs[2]] == [[2, 1]] * 2
    assert runs[4][0]["mesh_shape"].tolist() == [2, 2]


def _single_device_dups(d):
    t = lambda k: torch.as_tensor(np.array(d[k]))
    return engine.mark_duplicates(
        *(t(k) for k in ("dbl_p5a", "dbl_orient", "dbl_p5b", "dbl_score",
                         "dbl_tile", "dbl_x", "dbl_y", "dbl_valid",
                         "sgl_p5", "sgl_rev", "sgl_score", "sgl_tile",
                         "sgl_x", "sgl_y", "sgl_valid")), int(d["ref_len"]))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_markdup_equals_single_device(runs, inputs, world):
    d, _ = inputs
    want_d, want_s = _single_device_dups(d)
    got_d = np.concatenate([r["dup_dbl"] for r in runs[world]])
    got_s = np.concatenate([r["dup_sgl"] for r in runs[world]])
    assert not any(bool(r["ovf"]) for r in runs[world])
    np.testing.assert_array_equal(got_d, want_d.numpy())
    np.testing.assert_array_equal(got_s, want_s.numpy())
    assert got_d.sum() > 0 and got_s.sum() > 0


def test_sharded_markdup_equals_jax_mesh(runs, inputs):
    import jax
    from jax.sharding import Mesh

    d, jargs = inputs
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("sp",))
    jd, js, ovf = jshd.sharded_mark_duplicates(
        mesh, jargs, *_split(2 * d["ref_len"]))
    assert not ovf
    for world in WORLDS:
        np.testing.assert_array_equal(
            np.concatenate([r["dup_dbl"] for r in runs[world]]),
            np.asarray(jd))
        np.testing.assert_array_equal(
            np.concatenate([r["dup_sgl"] for r in runs[world]]),
            np.asarray(js))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_sort_equals_single_device(runs, inputs, world):
    d, _ = inputs
    want = engine.coordinate_sort_order(
        torch.as_tensor(d["uc"]), torch.as_tensor(d["valid"])).numpy()
    got = np.concatenate([r["order"] for r in runs[world]])
    assert not any(bool(r["sort_ovf"]) for r in runs[world])
    np.testing.assert_array_equal(got, want[:int(d["valid"].sum())])


def test_sharded_sort_equals_jax_mesh(runs, inputs):
    import jax
    from jax.sharding import Mesh

    d, _ = inputs
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("sp",))
    hi, lo = (jnp.asarray(a) for a in _split(d["uc"]))
    want, ovf = jshd.sharded_coordinate_sort(
        mesh, hi, lo, jnp.asarray(d["valid"]), *_split(d["total"]))
    assert not ovf
    for world in WORLDS:
        np.testing.assert_array_equal(
            np.concatenate([r["order"] for r in runs[world]]), want)


@pytest.mark.parametrize("world", (2, 4))
def test_sharded_markdup_overflow_flag(runs, world):
    assert all(bool(r["small_cap_ovf"]) for r in runs[world])


def test_shard_align_fn_equals_one_process(runs):
    r = runs[2][0]
    keys = [k[len("align_whole_"):] for k in r if
            k.startswith("align_whole_")]
    assert "rb" in keys and r["align_whole_valid"].shape[0] == ALIGN_READS
    assert r["align_whole_valid"].sum() >= ALIGN_READS // 2
    for k in keys:
        np.testing.assert_array_equal(r[f"align_dp_{k}"],
                                      r[f"align_whole_{k}"], err_msg=k)


@pytest.mark.parametrize("world", (2, 4))
def test_sharded_fm_gather_equals_unsharded(runs, world):
    """occ4 and sa_lookup through the fm-sharded tables equal the whole
    tables' on every rank, the padded tail and both clip edges
    included."""
    for r in runs[world]:
        for name in ("occ4", "sa"):
            np.testing.assert_array_equal(r[f"mesh2d_{name}_sharded"],
                                          r[f"mesh2d_{name}_whole"],
                                          err_msg=name)


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("cap,engine", MESH2D_RUNS)
def test_shard_align_fn_2d_equals_one_process(runs, world, cap, engine):
    """shard_align_fn_2d on the fm-sharded index: every rank's gathered
    regs equal one process's device_align on the unsharded index over
    each dp row block (the whole batch at dp 1), on a batch whose reads
    overflow and go up the ladder."""
    tag = f"mesh2d_{cap}_{engine}"
    for r in runs[world]:
        keys = [k[len(tag) + 7:] for k in r if k.startswith(tag + "_whole_")]
        assert "rb" in keys and "overflow" in keys
        for k in keys:
            np.testing.assert_array_equal(r[f"{tag}_got_{k}"],
                                          r[f"{tag}_whole_{k}"], err_msg=k)
    whole = runs[world][0]
    assert whole[f"{tag}_whole_valid"].shape[0] == ALIGN_READS
    if cap == "tight":
        assert whole[f"{tag}_whole_overflow"].sum() >= ALIGN_READS // 2
