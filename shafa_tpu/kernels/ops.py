"""Shared device primitives: scans, segment binary search, compaction.

Everything is shape-static and jit-safe; batch dimension B is blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def exclusive_cumsum(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    inc = jnp.cumsum(x, axis=axis)
    return inc - x


#: Query-chunk width for output-centric emission. Chunking through lax.map
#: reuses one chunk's gather/elementwise intermediates across iterations
#: instead of allocating all of them at once (an unrolled 536M-query
#: emission would hold ~30 such arrays of that length).
EMIT_CHUNK = 1 << 22


def map_query_chunks(emit, n: int, chunk: int = EMIT_CHUNK) -> jnp.ndarray:
    """concat(emit(q) for q in chunks of [0, n)) with buffer reuse.

    emit takes a (chunk,) int32 array of global query indices (values >= n
    possible in the last chunk — emit must mask) and returns a (chunk,)
    array. Single-chunk calls skip the scan wrapper entirely.
    """
    if n <= chunk:
        q = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)[0]
        return emit(q)
    n_chunks = -(-n // chunk)
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, chunk), 1)[0]
    out = jax.lax.map(lambda c: emit(c * chunk + iota),
                      jnp.arange(n_chunks, dtype=jnp.int32))
    return out.reshape(n_chunks * chunk)[:n]


def searchsorted_last_le(keys_flat: jnp.ndarray, base: jnp.ndarray,
                         n: int, q: jnp.ndarray) -> jnp.ndarray:
    """Vectorized per-segment binary search: last k with keys[base+k] <= q.

    keys_flat holds concatenated sorted segments of length n; base is each
    query's segment offset. Returns -1 when keys[base] > q. This is the
    building block of all variable-rate emission here: every "place values
    at computed offsets" kernel is inverted into "for every output slot,
    binary-search which value covers it", so each output is written once by
    a gather and no scatter is needed.
    """
    ub = jnp.zeros(q.shape, jnp.int32)  # count of entries <= q
    step = 1 << max(0, (n - 1).bit_length() - 1)
    while step:
        idx = ub + (step - 1)
        probe = keys_flat[base + jnp.minimum(idx, n - 1)]
        ub = ub + jnp.where((idx < n) & (probe <= q), step, 0)
        step >>= 1
    return ub - 1


def compact_rows(rows: jnp.ndarray, lens: jnp.ndarray, out_sz: int):
    """Concatenate the valid prefixes of each row into one flat vector.

    rows (B, Q) uint8, lens (B,) -> (out_sz,) uint8 with
    out[cumsum(lens)[i-1] : cumsum(lens)[i]] = rows[i, :lens[i]] and zeros
    past lens.sum(). Output-centric: each output byte binary-searches its
    source row.
    """
    b, q = rows.shape
    lens = lens.astype(jnp.int32)
    bounds = jnp.cumsum(lens)  # (B,) row end offsets
    rows_flat = rows.ravel()

    def emit(pos):
        # row r covers [bounds[r-1], bounds[r]): first r with bounds[r] > pos
        r = searchsorted_last_le(bounds, jnp.int32(0), b, pos) + 1
        r = jnp.minimum(r, b - 1)
        start = bounds[r] - lens[r]
        valid = pos < bounds[b - 1]
        src = r * q + (pos - start)
        out = rows_flat[jnp.where(valid, src, 0)]
        return jnp.where(valid, out, 0).astype(jnp.uint8)

    return map_query_chunks(emit, out_sz)
