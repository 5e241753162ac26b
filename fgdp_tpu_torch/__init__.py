"""fgdp_tpu_torch — the PyTorch/CUDA port of fgdp_tpu.

A second package beside the JAX one (which stays the reference): the
same alignment stage on an NVIDIA H100, with the TPU's Pallas kernels on
its path rewritten by hand for Hopper (csrc/). It imports torch and
numpy, never jax and nothing of fgdp_tpu: host code it needs is copied.

Layering (bottom → top), mirroring fgdp_tpu:
  utils/  io/  index/   host-side foundations (+ device index tensors)
  ops/                  device ops and the kernel wrappers
  align/                seeding, chaining, extension, host finalize
  call/                 mutect: host stages, PairHMM on the card, BQSR,
                        the CNN gate
  pipeline.py           the Aligner (single- and paired-end) and its
                        overflow ladder
  parallel/             the contig-sharded aligner; torch.distributed
                        meshes, data-parallel alignment, sharded sort +
                        duplicate marking
  cli.py                `python -m fgdp_tpu_torch index|mem|sormadup|
                        mutect|pipeline`
"""

__version__ = "0.1.0"
