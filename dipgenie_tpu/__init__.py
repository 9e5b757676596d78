"""dipgenie_tpu — a JAX pangenome haplotype-inference engine.

A from-scratch reimplementation of the capabilities of DipGenie ("PHI"):
infer one (haploid) or two (diploid) full haplotype sequences from
low-coverage short reads and a pangenome graph, via (w,k)-minimizer
matching plus a recombination-constrained dynamic program over a
haplotype-expanded graph.

Architecture (not a port):
  - Host layer (Python + C++ via ctypes): GFA/FASTQ I/O, graph
    construction, expanded-graph levelization, FASTA output, and the
    native C++ diploid DP tier.
  - Device layer (plain JAX on XLA, run on an NVIDIA GPU): minimizer
    sketching, MurmurHash3, k-mer mixture-model grid fitting, and the
    level-synchronous diploid pair DP as masked vectorized steps.
  - parallel/: jax.sharding Mesh + shard_map data-parallel read
    pipeline and pair-tile sharding for the DP.

Reference behavior is documented per-module with reference file:line
citations (reference at /root/reference, read-only).
"""

__version__ = "0.1.0"

PHI_VERSION = "1.0"  # reference version string parity (src/PHI.h:9)
