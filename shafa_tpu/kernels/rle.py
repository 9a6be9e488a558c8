"""RLE encode/expand — module F's block_compression (f.c:29-55) and module
D's rle_block_decompressor (d.c:116-197), as batched segment-scan kernels.

Encode formulation (no byte-serial loop):
  1. run boundaries  change[i] = (i==0) | (x[i] != x[i-1])
  2. 255-cap splits  sub_start = change | ((i - run_start) % 255 == 0)
  3. per-position sub geometry via cummax / reverse-cummin — every quantity
     (sub start, sub length, escape decision) is computable POINTWISE because
     all bytes of a sub-segment share the same symbol and length
  4. per-position output contribution (escape start: 3, literal: 1, else 0)
     -> inclusive cumsum = output extents
  5. OUTPUT-CENTRIC emission: every output byte binary-searches its emitting
     input lane (first lane whose cumulative extent exceeds it) and picks
     0x00 / symbol / count / literal from the lane's fields by its relative
     offset (see ops.searchsorted_last_le).

Escape rule parity with the reference: a sub-segment is escaped iff its
length >= 4 or its symbol is 0x00; literals of short runs are emitted one
byte per position (f.c:47-52 advances by one). Runs never cross the true
block end (mask), and never cross the 255 cap.

Expand formulation: token starts form a chain i -> i + (3 if x[i]==0 else 1)
(a 0x00 may be escape payload, so token boundaries are history-dependent);
the chain is resolved by pointer doubling over a flattened per-row jump
table; output bytes then binary-search their emitting token over the
inclusive cumsum of token repeat counts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .ops import map_query_chunks, searchsorted_last_le

MAX_RUN = 255
MIN_ESCAPE_RUN = 4


def rle_out_bound(p: int) -> int:
    """Worst-case RLE output for a p-byte block (alternating 0,x doubles),
    rounded up to a 512-multiple so downstream shapes stay aligned."""
    return (2 * p + 8 + 511) & ~511


def _rle_analyze(x: jnp.ndarray, lengths: jnp.ndarray):
    """Shared per-lane run analysis (traced inside rle_encode_batch).

    Returns (xi, valid, sub_start, sub_len, escaped, contrib): every lane's
    sub-segment geometry and its output contribution in bytes (3 at an
    escape start, 1 for a literal, 0 inside an escaped run / padding).
    """
    b, p = x.shape
    xi = x.astype(jnp.int32)
    pos = jax.lax.broadcasted_iota(jnp.int32, (b, p), 1)
    valid = pos < lengths[:, None]

    prev = jnp.pad(xi[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
    change = (xi != prev) | (pos == 0)
    run_start = jax.lax.cummax(jnp.where(change, pos, 0), axis=1)
    sub_start = (change | ((pos - run_start) % MAX_RUN == 0)) & valid

    # Next sub start strictly after i == this sub's end (for i inside a sub).
    start_pos = jnp.where(sub_start, pos, p)
    nxt = jax.lax.cummin(start_pos[:, ::-1], axis=1)[:, ::-1]
    nxt_after = jnp.concatenate(
        [nxt[:, 1:], jnp.full((b, 1), p, jnp.int32)], axis=1)
    sub_end = jnp.minimum(nxt_after, lengths[:, None])
    sstart = jax.lax.cummax(jnp.where(sub_start, pos, 0), axis=1)
    sub_len = sub_end - sstart  # same value at every position of the sub

    escaped = (sub_len >= MIN_ESCAPE_RUN) | (xi == 0)  # pointwise-correct
    contrib = jnp.where(valid,
                        jnp.where(escaped, jnp.where(sub_start, 3, 0), 1), 0)
    return xi, valid, sub_start, sub_len, escaped, contrib


@jax.jit
def rle_encode_batch(x: jnp.ndarray, lengths: jnp.ndarray):
    """(B, P) uint8 + (B,) lengths -> ((B, rle_out_bound(P)) uint8, (B,) out
    lengths). Bytes past each row's out length are zero."""
    b, p = x.shape
    out_p = rle_out_bound(p)
    xi, valid, sub_start, sub_len, escaped, contrib = _rle_analyze(x, lengths)
    cum = jnp.cumsum(contrib, axis=1)  # inclusive: lane i's output extent end
    out_len = cum[:, -1]

    # Output-centric emission: output byte j of row r is produced by the
    # first lane e with cum[e] > j (lanes with contrib 0 are never picked:
    # cum[e] > j needs contrib[e] > 0 at the boundary). rel = j - off[e]
    # selects 0x00 / symbol / count within an escape triple.
    cum_flat = cum.ravel()
    contrib_flat = contrib.ravel()
    xi_flat = xi.ravel()
    sublen_flat = sub_len.ravel()

    def emit(q):
        r = jnp.minimum(q // out_p, b - 1)
        j = q % out_p
        e = searchsorted_last_le(cum_flat, r * p, p, j) + 1
        e = r * p + jnp.minimum(e, p - 1)
        c_e = contrib_flat[e]
        rel = j - (cum_flat[e] - c_e)
        trip = jnp.where(rel == 0, 0,
                         jnp.where(rel == 1, xi_flat[e], sublen_flat[e]))
        byte = jnp.where(c_e == 3, trip, xi_flat[e])
        return jnp.where(j < out_len[r], byte, 0).astype(jnp.uint8)

    out = map_query_chunks(emit, b * out_p)
    return out.reshape(b, out_p), out_len


def _token_starts(xi: jnp.ndarray) -> jnp.ndarray:
    """Token-start mask per row: orbit of 0 under i -> i + (3 if 0x00 else 1).

    Formulated as a 3-state FSM scan instead of pointer doubling: the state
    before byte i is "escape-payload bytes still pending" in {0, 1, 2}; a
    byte seen in state 0 is a token start (and an 0x00 start pends 2 payload
    bytes). Per-byte transitions are functions {0,1,2}->{0,1,2}; composition
    is associative and, encoded as a 3-vector of next-states, costs a few
    selects — so lax.associative_scan runs the whole history-dependent
    tokenization in log2(P) elementwise rounds, with no gathers.
    """
    b, p = xi.shape
    esc = xi == 0
    # transition f = (f(0), f(1), f(2)): state 0 -> 2 if escape else 0;
    # state 1 -> 0; state 2 -> 1 (countdown)
    f0 = jnp.where(esc, 2, 0).astype(jnp.int8)
    f1 = jnp.zeros_like(f0)
    f2 = jnp.ones_like(f0)

    def compose(a, c):
        # (a then c): out(s) = c(a(s)); scan order left-to-right
        a0, a1, a2 = a
        c0, c1, c2 = c

        def sel(s):
            return jnp.where(s == 0, c0, jnp.where(s == 1, c1, c2)) \
                .astype(jnp.int8)

        return sel(a0), sel(a1), sel(a2)

    s0, _, _ = jax.lax.associative_scan(compose, (f0, f1, f2), axis=1)
    # state BEFORE byte i = composed transition of bytes [0, i) applied to 0
    state_before = jnp.pad(s0[:, :-1], ((0, 0), (1, 0)))
    return state_before == 0


def _token_fields(x: jnp.ndarray, lengths: jnp.ndarray):
    xi = x.astype(jnp.int32)
    b, p = xi.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (b, p), 1)
    valid = pos < lengths[:, None]
    is_start = _token_starts(xi) & valid
    x1 = jnp.pad(xi[:, 1:], ((0, 0), (0, 1)))
    x2 = jnp.pad(xi[:, 2:], ((0, 0), (0, 2)))
    esc = is_start & (xi == 0)
    sym = jnp.where(esc, x1, xi)
    # zero-count escape emits one copy (d.c:179-184)
    cnt = jnp.where(is_start, jnp.where(esc, jnp.maximum(x2, 1), 1), 0)
    return is_start, sym, cnt


@jax.jit
def rle_expand_sizes(x: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """Exact decompressed size per row (cheap pre-pass to size buffers)."""
    _, _, cnt = _token_fields(x, lengths)
    return cnt.sum(axis=1)


@functools.partial(jax.jit, static_argnames=("out_p",))
def rle_expand_batch(x: jnp.ndarray, lengths: jnp.ndarray, out_p: int):
    """(B, P) uint8 RLE streams -> ((B, out_p) uint8, (B,) output lengths).

    out_p must be >= the largest decompressed block in the batch (caller
    computes exact sizes via rle_expand_sizes and pads to a bucket).
    Output-centric: each output byte binary-searches its emitting token over
    the inclusive cumsum of token counts, then gathers the token's symbol.
    """
    b, p = x.shape
    _, sym, cnt = _token_fields(x, lengths)
    cum = jnp.cumsum(cnt, axis=1)
    out_len = cum[:, -1]
    cum_flat = cum.ravel()
    sym_flat = sym.ravel()

    def emit(q):
        r = jnp.minimum(q // out_p, b - 1)
        j = q % out_p
        e = searchsorted_last_le(cum_flat, r * p, p, j) + 1
        byte = sym_flat[r * p + jnp.minimum(e, p - 1)]
        return jnp.where(j < out_len[r], byte, 0).astype(jnp.uint8)

    out = map_query_chunks(emit, b * out_p)
    return out.reshape(b, out_p), out_len


@functools.partial(jax.jit, static_argnames=("out_sz",))
def rle_expand_compact(x: jnp.ndarray, lengths: jnp.ndarray, out_sz: int):
    """Fused expand + row compaction: all rows' decompressed bytes
    concatenated in order into one (out_sz,) uint8 buffer (the exact bytes
    the host writes), skipping the (B, out_p) padded byte intermediate.

    Output-centric: every output byte binary-searches its row, then its
    emitting token (~log2(B) + log2(P) gather probes per byte)."""
    b, p = x.shape
    _, sym, cnt = _token_fields(x, lengths)
    cum = jnp.cumsum(cnt, axis=1)
    row_len = cum[:, -1]
    bounds = jnp.cumsum(row_len)
    cum_flat = cum.ravel()
    sym_flat = sym.ravel()

    def emit(pos):
        r = searchsorted_last_le(bounds, jnp.int32(0), b, pos) + 1
        r = jnp.minimum(r, b - 1)
        j = pos - (bounds[r] - row_len[r])
        e = searchsorted_last_le(cum_flat, r * p, p, j) + 1
        byte = sym_flat[r * p + jnp.minimum(e, p - 1)]
        return jnp.where(pos < bounds[b - 1], byte, 0).astype(jnp.uint8)

    return map_query_chunks(emit, out_sz)
