"""Device kernels (plain JAX/XLA) for the codec's hot paths.

  * rle       RLE encode / expand as segment scans + output-centric gathers;
  * histogram 256-bin byte counts per block;
  * pack      Shannon-Fano bit-pack (per-block code LUT + bit-offset scan);
  * decode    prefix decode by code rank + pointer-doubling symbol chain;
  * ops       shared primitives (scans, segment binary search, compaction).
"""

from . import histogram, ops, pack, rle  # noqa: F401
