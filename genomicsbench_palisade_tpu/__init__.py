"""genomicsbench_palisade_tpu — a GPU genomics kernel engine in JAX.

A from-scratch JAX/XLA framework (one CUDA kernel through jax.ffi) with the capabilities of the
GenomicsBench suite (reference: JustKshitijD/genomicsbench_palisade):

  * PairHMM forward likelihoods (GATK/GKL semantics)      -> ops.phmm
  * Banded Smith-Waterman seed extension (bwa-mem2)       -> ops.bsw
  * minimap2-style anchor chaining DP                     -> ops.chain
  * FM-index SMEM seeding (bwa-mem2)                      -> ops.fmi, index.fmi_index
  * Canonical k-mer counting (Flye)                       -> ops.kmer
  * Partial-order alignment consensus (spoa)              -> ops.poa
  * GRM genotype matrix (plink2 --make-grm-bin)           -> ops.grm
  * NN inference models (basecalling / variant calling)   -> models/

Design: host-side parsing + padding/bucketing feeds fixed-shape device
batches; inner DP loops are lax.scan wavefronts, and the PairHMM forward
pass is a CUDA kernel (native/cuda/phmm_forward.cu); matmul-shaped work
(GRM, NN) goes to cuBLAS/cuDNN through XLA; multi-device scaling goes
through jax.sharding.Mesh + shard_map with psum/all_gather merges.

The HE (PALISADE) layer of the reference fork is an encryption veneer over
the plaintext kernels and is intentionally out of scope (see SURVEY.md §0).
"""

__version__ = "0.1.0"
