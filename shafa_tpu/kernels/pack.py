"""Bit-pack encode — module C's binary_coding (c.c:52-83), batched.

The reference's trick is a pre-shifted 8-offset table so its inner loop is
branchless ORs (c.c:104,186-219). The vector equivalent here is fully
OUTPUT-CENTRIC: every output byte is computed by gathers, with no scatter:

  1. per-symbol (len, leftaligned32) lookup: a gather from the block's
     256-entry table
  2. bit offsets = exclusive cumsum of lengths (MSB-first stream order);
     symbol k owns the bit interval [off[k], off[k+1])  — the intervals
     PARTITION the stream, so "which symbols touch output byte o" is a
     contiguous run of at most 9 (8 one-bit starts + 1 spanning code)
  3. every output byte binary-searches the last symbol starting at-or-before
     its first bit (searchsorted_last_le), then ORs the aligned slices of
     the <=9 candidate codes — gathers and shifts.

Codes longer than 32 bits (pathological skew; needs a block > 2^32 bytes to
even approach optimality) fall back to the numpy oracle at the backend level.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .ops import exclusive_cumsum, map_query_chunks, searchsorted_last_le

MAX_CODE_BITS = 32
#: max symbols whose bit interval can intersect one output byte
CANDIDATES = 9


def pack_out_bound(p: int) -> int:
    """Worst-case packed bytes for p symbols of <=32-bit codes (rounded to
    a 512-multiple; see rle_out_bound)."""
    return (4 * p + 16 + 511) & ~511


def pack_stage1(x: jnp.ndarray, lengths: jnp.ndarray,
                code_lens: jnp.ndarray, code_vals: jnp.ndarray):
    """LUT lookup + bit-offset scan: (off, val, bit_total, out_len_bytes).

    A separate compile unit from the emission stage (pack_batch,
    pack_batch_compact), chained through device-resident arrays.
    """
    b, p = x.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (b, p), 1)
    valid = pos < lengths[:, None]
    xi = x.astype(jnp.int32)
    ln = jnp.take_along_axis(jnp.asarray(code_lens, jnp.int32), xi, axis=1)
    val = jnp.take_along_axis(jnp.asarray(code_vals, jnp.uint32), xi, axis=1)
    ln = jnp.where(valid, ln, 0)
    off = exclusive_cumsum(ln, axis=1)  # bit offsets
    bit_total = off[:, -1] + ln[:, -1]
    out_len = (bit_total + 7) >> 3
    return off, val, bit_total, out_len


def _emit_bytes(off_ext_flat: jnp.ndarray, val_flat: jnp.ndarray,
                base_ext: jnp.ndarray, base_val: jnp.ndarray,
                p: int, q: jnp.ndarray) -> jnp.ndarray:
    """OR together the candidate code slices covering bit window [q, q+8).

    off_ext_flat: per-row (P+1) monotone bit offsets (last = row bit total),
    flattened; base_ext/base_val: each query's row base; q: first bit of the
    output byte. Candidate k contributes iff its interval [off[k], off[k+1])
    intersects the window and is nonempty (padding lanes are zero-length).
    """
    k0 = searchsorted_last_le(off_ext_flat, base_ext, p, q)
    byte = jnp.zeros(q.shape, jnp.uint32)
    for t in range(CANDIDATES):
        k = k0 + t
        kc = jnp.minimum(k, p - 1)
        o_k = off_ext_flat[base_ext + kc]
        e_k = off_ext_flat[base_ext + kc + 1]
        v_k = val_flat[base_val + kc]
        ok = (k == kc) & (o_k <= q + 7) & (e_k > q) & (e_k > o_k)
        d = q - o_k  # byte's first bit, relative to code start: [-7, 31]
        sh_r = jnp.clip(24 - d, 0, 31).astype(jnp.uint32)
        sh_l = jnp.clip(d - 24, 0, 31).astype(jnp.uint32)
        c = jnp.where(d <= 24, v_k >> sh_r, v_k << sh_l) & jnp.uint32(0xFF)
        byte = byte | jnp.where(ok, c, jnp.uint32(0))
    return byte


def pack_stage2(off: jnp.ndarray, val: jnp.ndarray, bit_total: jnp.ndarray):
    """Emission into per-row padded buffers: (B, 4P+16) uint8.

    Bits past each row's bit_total come out zero (the candidate conditions
    fail), reproducing the reference's zero-padded final byte (c.c:58,80).
    """
    b, p = off.shape
    out_p = pack_out_bound(p)
    off_ext_flat = jnp.concatenate([off, bit_total[:, None]], axis=1).ravel()
    val_flat = val.ravel()

    def emit(q):
        r = jnp.minimum(q // out_p, b - 1)
        o = q % out_p
        return _emit_bytes(off_ext_flat, val_flat, r * (p + 1), r * p,
                           p, o * 8).astype(jnp.uint8)

    byte = map_query_chunks(emit, b * out_p)
    return byte.reshape(b, out_p)


def pack_compact(off: jnp.ndarray, val: jnp.ndarray, bit_total: jnp.ndarray,
                 out_len: jnp.ndarray, out_sz: int):
    """Fused emission + row compaction: all rows' packed bytes concatenated.

    (out_sz,) uint8 with rows in order and no inter-row padding — the exact
    bytes the host writes into `.shaf`. Skips materializing the (B, 4P+16)
    padded buffer entirely: each of the out_sz output bytes binary-searches
    its row, then its covering symbols. out_sz >= out_len.sum() (bucketed).
    """
    b, p = off.shape
    off_ext_flat = jnp.concatenate([off, bit_total[:, None]], axis=1).ravel()
    val_flat = val.ravel()
    row_bytes = out_len.astype(jnp.int32)
    bounds = jnp.cumsum(row_bytes)

    def emit(pos):
        r = searchsorted_last_le(bounds, jnp.int32(0), b, pos) + 1
        r = jnp.minimum(r, b - 1)
        o = pos - (bounds[r] - row_bytes[r])
        byte = _emit_bytes(off_ext_flat, val_flat, r * (p + 1), r * p,
                           p, o * 8)
        return jnp.where(pos < bounds[b - 1], byte, 0).astype(jnp.uint8)

    return map_query_chunks(emit, out_sz)


_stage1_jit = jax.jit(pack_stage1)
_stage2_jit = jax.jit(pack_stage2)
_compact_jit = jax.jit(pack_compact, static_argnames=("out_sz",))


def pack_batch(x: jnp.ndarray, lengths: jnp.ndarray,
               code_lens: jnp.ndarray, code_vals: jnp.ndarray):
    """Pack (B, P) uint8 symbol streams with per-block code tables.

    code_lens: (B, 256) int32; code_vals: (B, 256) uint32 (left-aligned).
    Returns ((B, 4P+16) uint8 packed, (B,) packed byte lengths); bytes past
    each row's length are zero. The two stages run as separate jit calls,
    device-resident between them.
    """
    off, val, bit_total, out_len = _stage1_jit(x, lengths, code_lens,
                                               code_vals)
    return _stage2_jit(off, val, bit_total), out_len


def pack_batch_compact(x, lengths, code_lens, code_vals, out_sz_fn):
    """Pack + compact without the padded intermediate: (flat u8, out_len).

    out_sz_fn(total_bytes:int) -> static bucketed flat size. The (B,) packed
    lengths round-trip through host once (tiny) to fix the static out size.
    """
    off, val, bit_total, out_len = _stage1_jit(x, lengths, code_lens,
                                               code_vals)
    out_len_np = np.asarray(out_len)
    flat = _compact_jit(off, val, bit_total, out_len,
                        out_sz=out_sz_fn(int(out_len_np.sum())))
    return flat, out_len_np


def pack_byte_lens(hists: np.ndarray, code_lens: np.ndarray) -> np.ndarray:
    """Exact packed byte length per row from its stream histogram.

    bits(row) = sum_s hist[row, s] * code_len[row, s]; the histogram of the
    pack input is already on host (module T consumed it), so the mesh path
    sizes its per-shard output without a device pre-pass.
    """
    bits = (hists.astype(np.int64) * code_lens.astype(np.int64)).sum(axis=1)
    return (bits + 7) >> 3
