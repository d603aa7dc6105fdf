"""spacedust_tpu — accelerated conserved gene-cluster discovery engine.

A from-scratch JAX/XLA re-design of the capabilities of
soedinglab/spacedust, with a CUDA Smith-Waterman kernel for NVIDIA
Hopper GPUs: all-vs-all protein
homology search (k-mer prefilter + banded Smith-Waterman with
Karlin-Altschul E-values), per-genome-pair hit P-value aggregation, and
agglomerative clustering of hits by gene-neighborhood conservation.

Layer map (designed for the accelerator, not a port):
  db/        columnar SetDB storage + FASTA/GFF ingestion
  stats/     substitution matrices, Gumbel E-values, P-value chain (f64, host)
  ops/       device SW: the CUDA kernel (ops/cuda) and the XLA reference scan
  search/    prefilter + alignment orchestration
  cluster/   besthit / combinehits / clusterhits / summarize
  parallel/  mesh + sharding policy
  workflow/  createsetdb / clustersearch pipelines with checkpoint-resume
"""

__version__ = "0.1.0"
