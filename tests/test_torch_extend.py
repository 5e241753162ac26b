"""extend_chains of the port against fgdp_tpu's: from the same ChainBatch
the AlnRegBatch must be exactly equal, field by field; the packed wire
buffer the pipeline ships must be equal too."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgdp_tpu import pipeline as jpipeline
from fgdp_tpu.align import chain as jchain
from fgdp_tpu.align import extend as jextend
from fgdp_tpu.align import seeding as jseeding
from fgdp_tpu.config import AlignConfig as JAlignConfig
from fgdp_tpu_torch import pipeline
from fgdp_tpu_torch.align import extend
from fgdp_tpu_torch.align.chain import ChainBatch
from fgdp_tpu_torch.config import AlignConfig

from test_torch_seeding import (build_both, one_torch_thread,  # noqa: F401
                                read_codes)


@pytest.mark.parametrize("ref,fq,E,jpr", [
    ("ref.fa", "se.fq", 24, 6),
    ("rep_ref.fa", "rep.fq", 24, 6),
    ("rep_ref.fa", "rep.fq", 2, 1),       # tiny caps: reg/lane overflow
])
def test_extend_chains_equal(ref, fq, E, jpr):
    j, t = build_both(ref)
    codes, lens = read_codes(fq, 48)
    opt = JAlignConfig()
    jb = jseeding.collect_seeds(
        j["dfm"], j["dref"], jnp.asarray(codes), jnp.asarray(lens),
        jnp.ones(len(lens), bool), opt, max_seeds=96,
        lcp_tree=j["tree"], lcp_isa=j["isa"])
    jcb = jchain.chain_seeds(j["dfm"], j["dref"], jb, jnp.asarray(lens),
                             opt, max_seedpos=192, max_chains=24,
                             use_pallas=False)
    jfn = jax.jit(functools.partial(jextend.extend_chains, opt=opt,
                                    max_regs=E, t_max=304,
                                    jobs_per_read=jpr))
    want = jfn(jcb, jnp.asarray(codes), jnp.asarray(lens), j["dref"])
    cb = ChainBatch(*(torch.tensor(np.asarray(a)) for a in jcb))
    got = extend.extend_chains(cb, torch.as_tensor(codes),
                               torch.as_tensor(lens), t["dref"],
                               AlignConfig(), max_regs=E, t_max=304,
                               jobs_per_read=jpr)
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    if E == 2:
        assert bool(got.overflow.any())
    # the transfer compaction + wire packing of the pipeline
    for k, cap in ((2, 1), (16, 6)):
        jbuf = jpipeline.pack_regs(jpipeline.compact_regs(want, k), cap)
        tbuf = pipeline.pack_regs(pipeline.compact_regs(got, k), cap)
        np.testing.assert_array_equal(np.asarray(jbuf), tbuf.numpy())
        jnp_out = jpipeline.unpack_regs(np.asarray(jbuf))
        t_out = pipeline.unpack_regs(tbuf.numpy())
        for f in jnp_out:
            np.testing.assert_array_equal(jnp_out[f], t_out[f], err_msg=f)
