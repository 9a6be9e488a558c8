"""shafa_tpu — a JAX/XLA lossless codec implementing the Shafa format.

A from-scratch JAX/XLA framework with the capabilities of the reference
C implementation (Fytex/Shafa-CD): RLE + Shannon-Fano block compression with
bit-compatible .rle/.freq/.cod/.shaf sidecar formats, re-architected for an
accelerator (an NVIDIA H100 GPU; tests run on the CPU backend):
block-level data parallelism over a device mesh replaces the reference's
pthread pipeline, and the byte-sequential hot loops become vectorized
scan/gather formulations.

Layers (mirroring SURVEY.md §7):
  formats / geometry / codes  host-side format ABI + block math
  oracle                      exact NumPy implementations (CPU fallback)
  kernels/                    JAX/XLA device kernels
  device                      batched device backend (padding, masking)
  dist                        mesh + shard_map block sharding
  pipeline / cli              stage drivers + reference-compatible CLI
"""

__version__ = "0.1.0"
