"""Guards of the port: it imports neither jax nor fgdp_tpu, its entry
points never fall back to the CPU silently, and CUDA tensors never reach
a plain PyTorch version through the kernel wrappers."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from fgdp_tpu_torch.align import chain
from fgdp_tpu_torch.ops import kswv, pairhmm, sw
from fgdp_tpu_torch.probes import gather, vpu_ceiling
from fgdp_tpu_torch.utils import device as devmod

from test_torch_seeding import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "fgdp_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "fgdp_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_no_forbidden_import_in_source():
    bad = []
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _forbidden(node.module or ""):
                    bad.append((path, node.module))
    assert not bad, bad


def test_port_runs_with_jax_and_fgdp_tpu_blocked(tmp_path):
    """Every port module imports, and a small CPU `mem`, `sormadup` of its
    SAM, `pipeline` and the golden `mutect` run, while a meta-path finder
    refuses jax and fgdp_tpu (a subprocess: the test process itself has
    jax loaded)."""
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, os, pkgutil, sys
        BLOCK = {FORBIDDEN!r}

        class Blocker(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCK:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Blocker())
        sys.path.insert(0, {ROOT!r})
        import fgdp_tpu_torch
        for m in pkgutil.walk_packages(fgdp_tpu_torch.__path__,
                                       "fgdp_tpu_torch."):
            if m.name != "fgdp_tpu_torch.__main__":
                importlib.import_module(m.name)
        import chip_smoke
        from fgdp_tpu_torch import cli
        golden = os.path.join({ROOT!r}, "tests", "golden")
        prefix = os.path.join({str(tmp_path)!r}, "idx")
        cli.main(["index", os.path.join(golden, "ref.fa"), prefix])
        out = os.path.join({str(tmp_path)!r}, "out.sam")
        cli.main(["mem", prefix, os.path.join(golden, "se.fq"), "-o", out,
                  "--device", "cpu", "-b", "64"])
        n = sum(1 for ln in open(out) if not ln.startswith("@"))
        assert n >= 150, n
        bam = os.path.join({str(tmp_path)!r}, "out.bam")
        cli.main(["sormadup", out, bam, "--device", "cpu"])
        pbam = os.path.join({str(tmp_path)!r}, "pipe.bam")
        cli.main(["pipeline", prefix, os.path.join(golden, "se.fq"), "-O",
                  pbam, "--device", "cpu", "-b", "64"])
        from fgdp_tpu_torch.io.bam import read_bam
        assert read_bam(bam)[3] == read_bam(pbam)[3]
        mt = os.path.join(golden, "mutect")
        vcf = os.path.join({str(tmp_path)!r}, "out.vcf")
        cli.main(["mutect", "-R", os.path.join(mt, "ref.fa"),
                  "-I", os.path.join(mt, "tumor.bam"),
                  "-N", os.path.join(mt, "normal.bam"), "-O", vcf,
                  "--device", "cpu"])
        assert sum(1 for ln in open(vcf) if not ln.startswith("#")) == 7
        loaded = [m for m in sys.modules if m.split(".")[0] in BLOCK]
        assert not loaded, loaded
        print("OK", n)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(ONE_THREAD_ENV)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().startswith("OK")


def test_no_device_without_cuda_raises(monkeypatch, tmp_path):
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.reference import DeviceReference, PackedReference
    from fgdp_tpu_torch.ops.fm import DeviceFMIndex
    from fgdp_tpu_torch.pipeline import Aligner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    pref = PackedReference.from_contigs(["c"], [rng.integers(0, 4, 500)])
    fm = FMIndex.build(pref.codes)
    with pytest.raises(RuntimeError, match="CUDA"):
        Aligner(pref, fm)
    with pytest.raises(RuntimeError, match="CUDA"):
        Aligner(pref, fm, device="cuda")
    # the device objects default to the card too
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceReference(pref)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceFMIndex.from_host(fm)
    from fgdp_tpu_torch import cli
    from fgdp_tpu_torch.call.engine import Mutect2Engine
    with pytest.raises(RuntimeError, match="CUDA"):
        Mutect2Engine(np.zeros(100, np.uint8), "c")
    mt = os.path.join(ROOT, "tests", "golden", "mutect")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["mutect", "-R", os.path.join(mt, "ref.fa"), "-I",
                  os.path.join(mt, "tumor.bam"), "-O", os.devnull])
    sam = os.path.join(ROOT, "tests", "golden", "se.oracle.sam")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["sormadup", sam, os.devnull])
    prefix = str(tmp_path / "idx")
    cli.main(["index", os.path.join(ROOT, "tests", "golden", "ref.fa"),
              prefix])
    golden = os.path.join(ROOT, "tests", "golden")
    for cmd in ("pipeline", "mem"):
        for reads in (["se.fq"], ["pe1.fq", "pe2.fq"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                cli.main([cmd, prefix,
                          *(os.path.join(golden, r) for r in reads),
                          "-O" if cmd == "pipeline" else "-o", os.devnull,
                          "-t", "2"])
    assert Mutect2Engine(np.zeros(100, np.uint8), "c",
                         device="cpu").device.type == "cpu"
    assert devmod.resolve_device("cpu").type == "cpu"
    assert DeviceReference(pref, device="cpu").codes.device.type == "cpu"
    assert DeviceFMIndex.from_host(fm, device="cpu").sa.device.type == "cpu"


class _CudaStub:
    """Stands in for a CUDA tensor at the wrappers' dispatch point."""

    is_cuda = True
    shape = (4, 8)


def test_cuda_tensors_never_reach_plain_versions(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []

    def fail_plain(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(sw, "sw_extend_plain", fail_plain)
    monkeypatch.setattr(chain, "chain_loop_plain", fail_plain)
    monkeypatch.setattr(pairhmm, "forward_f32", fail_plain)
    monkeypatch.setattr(kswv, "kswv_forward_plain", fail_plain)
    monkeypatch.setattr(sw, "sw_extend_kernel",
                        lambda *a, **k: calls.append("sw"))
    monkeypatch.setattr(chain, "chain_loop_kernel",
                        lambda *a, **k: calls.append("chain"))
    monkeypatch.setattr(pairhmm, "forward_f32_kernel",
                        lambda *a, **k: calls.append("pairhmm"))
    monkeypatch.setattr(kswv, "kswv_forward_kernel",
                        lambda *a, **k: calls.append("kswv"))
    monkeypatch.setattr(vpu_ceiling, "vpu_ceiling_plain", fail_plain)
    monkeypatch.setattr(gather, "gather_rows_plain", fail_plain)
    monkeypatch.setattr(vpu_ceiling, "vpu_ceiling_kernel",
                        lambda *a, **k: calls.append("vpu"))
    monkeypatch.setattr(gather, "gather_rows_kernel",
                        lambda *a, **k: calls.append("gather"))
    p = sw.SWParams(6, 1, 6, 1, 100, 5, 1)
    stub = _CudaStub()
    sw.sw_extend(stub, stub, stub, stub, stub, 100, p)
    chain.chain_loop(stub, stub, stub, stub, stub, stub, 10, 4, 100, 1000)
    pairhmm.forward_f32_any(stub, stub, stub, stub, stub, stub)
    kswv.kswv_forward(stub, stub, stub, stub, a=1, b=4, o_del=6, e_del=1,
                      o_ins=6, e_ins=1)
    vpu_ceiling.vpu_ceiling(stub, 3, 4)
    gather.gather_rows(stub, stub)
    assert calls == ["sw", "chain", "pairhmm", "kswv", "vpu", "gather"]


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise: CPU tensors
    are refused before any build or launch."""
    z = torch.zeros((4, 8), dtype=torch.int32)
    z1 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        sw.sw_extend_kernel(z, z1, z, z1, z1, 100,
                            sw.SWParams(6, 1, 6, 1, 100, 5, 1))
    with pytest.raises(ValueError):
        chain.chain_loop_kernel(z, z, z, z, z.bool(), z1.bool(), 10, 4,
                                100, 1000)
    f = torch.zeros((4, 8), dtype=torch.float32)
    with pytest.raises(ValueError):
        pairhmm.forward_f32_kernel(z, z1, f, torch.zeros((4, 8, 6)), z, z1)
    with pytest.raises(ValueError):
        kswv.kswv_forward_kernel(z, z1, z, z1, a=1, b=4, o_del=6, e_del=1,
                                 o_ins=6, e_ins=1)


def test_paired_finalize_never_leaves_the_card(tmp_path):
    """A finalize worker asked to rescue mates on the card raises when it
    cannot open it, and a pool without a device refuses paired batches
    (their mate rescue never moves to the CPU silently)."""
    from fgdp_tpu_torch.config import AlignConfig
    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.pipeline_stream import (FinalizePool,
                                                _finalize_worker_init)

    pref = PackedReference.from_contigs(
        ["c"], [np.random.default_rng(0).integers(0, 4, 500)])
    pref.save(str(tmp_path / "idx.ref"))
    with pytest.raises(RuntimeError, match="CUDA"):
        _finalize_worker_init(str(tmp_path / "idx.ref"), AlignConfig(),
                              "cuda")
    pool = FinalizePool(str(tmp_path / "idx.ref"), AlignConfig(), 1)
    try:
        with pytest.raises(ValueError, match="device"):
            pool.submit(["a", "a"], [np.zeros(5)] * 2, None, {}, 0,
                        paired=True)
    finally:
        pool.shutdown()


def test_deep_model_never_leaves_the_card(monkeypatch, tmp_path):
    """The CNN gate's forward runs on the card unless the caller asks
    for the CPU: without a card the filter, an engine with the gate and
    `mutect --deep-model` raise."""
    from fgdp_tpu_torch import cli
    from fgdp_tpu_torch.call.cnn_filter import CnnFilter
    from fgdp_tpu_torch.call.engine import Mutect2Engine

    from test_torch_cuda import gate_model

    model = gate_model(tmp_path / "gate.pt", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CnnFilter(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        Mutect2Engine(np.zeros(100, np.uint8), "c", cnn_model_path=model)
    mt = os.path.join(ROOT, "tests", "golden", "mutect_cnn")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["mutect", "-R", os.path.join(mt, "ref.fa"), "-I",
                  os.path.join(mt, "tumor.bam"), "-O", os.devnull,
                  "--deep-model", model])
    assert CnnFilter(model, device="cpu").device.type == "cpu"


def test_distributed_backend_follows_the_device(monkeypatch):
    """initialize() on a CUDA device asks for NCCL, never gloo; without a
    card it raises before any process group starts; one process is a
    no-op. The contig-sharded aligner defaults to the card too."""
    import torch.distributed as dist

    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.parallel import distributed as D
    from fgdp_tpu_torch.parallel.sharded_index import ShardedAligner

    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert D.initialize("localhost:1234", 2, 1) == 1
    assert D.initialize("tcp://localhost:1234", 2, 1, device="cuda") == 1
    assert [b for b, _ in seen] == ["nccl", "nccl"]
    assert seen[0][1] == dict(init_method="tcp://localhost:1234",
                              world_size=2, rank=1)
    assert D.initialize("localhost:1234", 1, 0, device="cuda") == 0
    assert len(seen) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            D.initialize("localhost:1234", 2, 0, device=device)
    assert len(seen) == 2
    assert D.initialize("localhost:1234", 2, 0, device="cpu") == 1
    assert seen[-1][0] == "gloo"
    pref = PackedReference.from_contigs(
        ["a", "b"], [np.random.default_rng(0).integers(0, 4, 300)] * 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedAligner(pref)
