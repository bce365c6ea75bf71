"""ngspeciesid — an amplicon species-ID engine in JAX.

A from-scratch JAX/XLA/CUDA re-design of the capabilities of
ksahlin/NGSpeciesID (reference mounted read-only at /root/reference):
quality-sort reads -> greedy minimizer clustering -> per-cluster POA
consensus -> primer/tail trimming -> reverse-complement dedup ->
polishing — with the inner loops as batched kernels (the alignment DP on
the GPU, the rest in a native C++ engine and numpy) instead of
parasail/edlib/spoa/racon/medaka subprocesses.

Layer map (see SURVEY.md section 7):
  io/        fastq/fasta codec, padded int8 batches, output writers
  utils/     phred tables, sequence utilities, empirical p-table asset
  ops/       compute primitives: scoring, minimizers, alignment DP,
             infix edit distance, POA consensus, pileup polishing
  native/    C++ host engine and the CUDA stats DP (built at first use)
  cluster/   wave-batched greedy clustering engine (reference semantics)
  consensus/ draft consensus, trimming, RC dedup, polish drivers
  models/    neural polisher (flax) — the learned medaka-equivalent head
  parallel/  jax.sharding mesh utilities, multi-host merge clustering
"""

__version__ = "0.1.0"
