"""Shannon-Fano prefix decode — module D's trie walk (d.c:514-551), batched.

The reference walks a pointer trie bit-by-bit (~8 branches per compressed
byte — its hottest loop). That cannot run on a vector machine; instead we
exploit two structural facts of the reference's code construction (codes.py):

  * the code set is COMPLETE (the split tree is full), so every 32-bit
    window starting at a symbol boundary falls in exactly one code interval
    [code << (32-len), next_code << (32-next_len));
  * codes in rank order are lexicographically increasing, so "which code"
    is a RANK: count of codes whose left-aligned value <= window.

Pipeline (all batched over blocks, flat over bit positions):
  1. windows    W[b] = 32 bits starting at bit b (byte shifts, no gather)
  2. rank       hierarchical compare: 16 pivots -> group, 16 in-group
                thresholds (fetched by one-hot matmul, exact via u16 halves)
  3. len/sym    prefix-delta dot products against the same compare masks
                (integer-exact in f32 at Precision.HIGHEST)
  4. chain      symbol starts p0=0, p_{k+1} = p_k + len[p_k]: pointer
                doubling with large-array gathers
  5. emit       gather sym at chain positions; positions past the known
                output count are masked (decode terminates on count, not
                input exhaustion — d.c:530).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

N_GROUPS = 16
GROUP = 16


# ---------------------------------------------------------------------------
# Host-side table construction (per block; 256 entries — negligible)
# ---------------------------------------------------------------------------

def decode_tables_u32(codes: list[str]):
    """Code strings -> fixed-shape decode tables for the kernel.

    Returns dict of numpy arrays:
      pc      (256,) uint32  left-aligned code values, rank order, padded 0
      pivots  (16,)  uint32  pc[::16]
      dlen2d  (16,16) int32  len deltas per rank (len[r]-len[r-1])
      plen    (16,)  int32   sum of dlen over full groups < g (prefix)
      dsym2d, psym           same for symbol values
      n_codes ()     int32
    Raises OverflowError for codes > 32 bits (backend falls back to oracle).
    """
    entries = [(len(c), int(c, 2), s) for s, c in enumerate(codes) if c]
    if not entries:
        raise ValueError("all-empty code table is undecodable")
    if max(e[0] for e in entries) > 32:
        raise OverflowError("code length > 32 bits")
    rows = sorted((v << (32 - ln), ln, s) for ln, v, s in entries)
    n = len(rows)
    pc = np.zeros(256, np.uint32)
    lens = np.zeros(256, np.int64)
    syms = np.zeros(256, np.int64)
    pc[:n] = [r[0] for r in rows]
    lens[:n] = [r[1] for r in rows]
    syms[:n] = [r[2] for r in rows]
    dlen = np.diff(np.concatenate(([0], lens[:n])))
    dsym = np.diff(np.concatenate(([0], syms[:n])))
    dlen_p = np.zeros(256, np.int64)
    dsym_p = np.zeros(256, np.int64)
    dlen_p[:n] = dlen
    dsym_p[:n] = dsym
    dlen2d = dlen_p.reshape(16, 16)
    dsym2d = dsym_p.reshape(16, 16)
    plen = np.concatenate(([0], np.cumsum(dlen2d.sum(1))))[:16]
    psym = np.concatenate(([0], np.cumsum(dsym2d.sum(1))))[:16]
    return {
        "pc": pc,
        "pivots": pc[::16].copy(),
        "dlen2d": dlen2d.astype(np.int32),
        "plen": plen.astype(np.int32),
        "dsym2d": dsym2d.astype(np.int32),
        "psym": psym.astype(np.int32),
        "n_codes": np.int32(n),
    }


def stack_decode_tables(tables: list[dict]):
    return {k: np.stack([t[k] for t in tables]) for k in tables[0]}


def decode_tables_batch(lens: np.ndarray, vals: np.ndarray) -> dict:
    """Vectorized decode_tables_u32 over a batch: no per-block Python.

    lens (n, 256) uint8, vals (n, 256) uint64 left-aligned (CodeTables
    layout). Every row must have max code length <= 32 and at least one code
    (callers filter; a violating row would silently decode garbage, so it
    raises ValueError).
    Produces the same stacked dict as stack_decode_tables(map(
    decode_tables_u32, ...)).
    """
    n = lens.shape[0]
    present = lens > 0
    n_codes = present.sum(1).astype(np.int32)
    if n and (int(lens.max()) > 32 or int(n_codes.min()) < 1):
        raise ValueError("decode tables need 1..32-bit codes in every row")
    # Sort present codes ascending by left-aligned value (rank order);
    # absent symbols to the back (their vals are 0, so force the key up).
    key = np.where(present, vals, np.uint64(0xFFFFFFFFFFFFFFFF))
    order = np.argsort(key, axis=1, kind="stable")
    rank_in = (np.arange(256)[None, :] < n_codes[:, None])
    lens_s = np.where(rank_in, np.take_along_axis(lens, order, 1), 0) \
        .astype(np.int64)
    syms_s = np.where(rank_in, order, 0).astype(np.int64)
    vals_s = np.take_along_axis(vals, order, 1)
    pc = np.where(rank_in, (vals_s >> np.uint64(32)).astype(np.uint32),
                  np.uint32(0))

    def deltas_prefix(x):
        d = np.diff(x, axis=1, prepend=0)
        d = np.where(rank_in, d, 0)
        d2 = d.reshape(n, 16, 16).astype(np.int32)
        gs = d2.sum(2)
        pref = np.concatenate(
            [np.zeros((n, 1), np.int64), np.cumsum(gs, axis=1,
                                                   dtype=np.int64)],
            axis=1)[:, :16].astype(np.int32)
        return d2, pref

    dlen2d, plen = deltas_prefix(lens_s)
    dsym2d, psym = deltas_prefix(syms_s)
    return {
        "pc": pc,
        "pivots": np.ascontiguousarray(pc[:, ::16]),
        "dlen2d": dlen2d,
        "plen": plen,
        "dsym2d": dsym2d,
        "psym": psym,
        "n_codes": n_codes,
    }


# ---------------------------------------------------------------------------
# Device kernel
# ---------------------------------------------------------------------------

def _windows32(payload: jnp.ndarray) -> jnp.ndarray:
    """(B, P) uint8 -> (B, 8P) uint32 windows in PLANE-MAJOR slot order.

    Slot i = s*P + j holds the 32-bit window starting at bit 8j + s.
    Plane-major keeps P minor-most; all consumers translate slot <-> bit
    arithmetically.
    """
    b, p = payload.shape
    by = payload.astype(jnp.uint32)

    def sh(k):
        return jnp.pad(by[:, k:], ((0, 0), (0, k)))

    w32 = (by << 24) | (sh(1) << 16) | (sh(2) << 8) | sh(3)
    b4 = sh(4)
    outs = []
    for s in range(8):
        if s == 0:
            outs.append(w32)
        else:
            outs.append((w32 << s) | (b4 >> (8 - s)))
    # (B, 8, P): plane s = windows at bit offset s within each byte
    return jnp.stack(outs, axis=1).reshape(b, 8 * p)


def _rank_fields(w: jnp.ndarray, t: dict):
    """Window values (B, N) uint32 + tables -> (len (B,N) i32, sym (B,N) i32).

    Hierarchical rank: coarse group via 16 pivots, in-group thresholds via
    one-hot matmul (u16 halves keep f32 matmuls exact), then prefix-delta
    dot products give len/sym without any 256-entry gather.
    """
    b, n = w.shape
    grp_ids = jnp.arange(N_GROUPS, dtype=jnp.int32)
    n_codes = t["n_codes"][:, None]  # (B,1)

    ge_piv = (w[..., None] >= t["pivots"][:, None, :]) \
        & (grp_ids * GROUP < n_codes)[:, None, :]
    c1 = ge_piv.sum(-1).astype(jnp.int32) - 1  # (B, N) group index

    oh = (c1[..., None] == grp_ids).astype(jnp.float32)  # (B, N, 16)

    def fetch16(tab2d_f32):  # (B,16,16) f32 -> (B,N,16) rows by group
        # HIGHEST: a reduced-precision f32 matmul (bf16 or TF32 inputs)
        # corrupts the 16-bit table halves (values up to 65535).
        return jax.lax.dot_general(
            oh, tab2d_f32.astype(jnp.float32),
            (((2,), (1,)), ((0,), (0,))),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)

    pc2d = t["pc"].reshape(b, 16, 16)
    row_hi = fetch16((pc2d >> 16).astype(jnp.float32))
    row_lo = fetch16((pc2d & 0xFFFF).astype(jnp.float32))
    rows = (row_hi.astype(jnp.uint32) << 16) | row_lo.astype(jnp.uint32)

    in_grp = jnp.arange(GROUP, dtype=jnp.int32)
    gidx = c1[..., None] * GROUP + in_grp
    ge_row = ((w[..., None] >= rows) & (gidx < n_codes[..., None])) \
        .astype(jnp.float32)

    def prefix_delta(d2d, pref):
        part = jnp.sum(ge_row * fetch16(d2d.astype(jnp.float32)), axis=-1)
        full = jnp.sum(oh.astype(jnp.float32)
                       * pref[:, None, :].astype(jnp.float32), axis=-1)
        return (part + full).astype(jnp.int32)

    ln = prefix_delta(t["dlen2d"], t["plen"])
    sym = prefix_delta(t["dsym2d"], t["psym"])
    return ln, sym


#: stage1 byte-chunk width: bounds the (B, 8*chunk, 16) one-hot temporaries
#: of the hierarchical rank. Unchunked, a (4, 8 MiB) batch would materialize
#: a 16 GB one-hot; at 2^18 bytes the peak temp is ~(B * 2^21 * 16 * 4)
#: bytes per buffer.
STAGE1_CHUNK = 1 << 18


def decode_stage1(payload: jnp.ndarray, tables: dict):
    """Window construction + per-bit-position rank: (len, sym) per bit.

    Chunked over byte positions with lax.map so the rank's one-hot
    temporaries stay bounded (see STAGE1_CHUNK); each chunk rebuilds its
    windows from a 4-byte-halo payload slice. Output stays in _windows32's
    plane-major slot order. Separate compile unit from the chain stage."""
    b, p = payload.shape
    cj = min(STAGE1_CHUNK, p)
    n_chunks = p // cj
    if n_chunks <= 1:
        return _rank_fields(_windows32(payload), tables)
    padded = jnp.pad(payload, ((0, 0), (0, 4)))

    def chunk_fn(c):
        seg = jax.lax.dynamic_slice(padded, (0, c * cj), (b, cj + 4))
        w = _windows32_halo(seg, cj)         # (B, 8*cj) plane-major
        ln, sym = _rank_fields(w, tables)
        return ln.reshape(b, 8, cj), sym.reshape(b, 8, cj)

    ln, sym = jax.lax.map(chunk_fn, jnp.arange(n_chunks, dtype=jnp.int32))
    # (nch, B, 8, cj) -> (B, 8, nch, cj) -> (B, 8P) plane-major
    ln = ln.transpose(1, 2, 0, 3).reshape(b, 8 * p)
    sym = sym.transpose(1, 2, 0, 3).reshape(b, 8 * p)
    return ln, sym


def _windows32_halo(seg: jnp.ndarray, cj: int) -> jnp.ndarray:
    """Windows for the first cj bytes of a (B, cj+4) slice (4-byte halo)."""
    b = seg.shape[0]
    by = seg.astype(jnp.uint32)

    def sh(k):
        return by[:, k:k + cj]

    w32 = (sh(0) << 24) | (sh(1) << 16) | (sh(2) << 8) | sh(3)
    b4 = sh(4)
    outs = []
    for s in range(8):
        outs.append(w32 if s == 0 else (w32 << s) | (b4 >> (8 - s)))
    return jnp.stack(outs, axis=1).reshape(b, 8 * cj)


def decode_stage2(ln: jnp.ndarray, sym: jnp.ndarray,
                  payload_lens: jnp.ndarray, out_counts: jnp.ndarray,
                  out_p: int):
    """Symbol chain (pointer doubling) + emission by known output count.

    ln/sym are in _windows32's plane-major slot order (slot s*P + j <-> bit
    8j + s); the chain jumps in bit space but stores/gathers in slot space —
    the translation is integer arithmetic on a power-of-two P.
    """
    b, nslots = ln.shape  # nslots == total bit count
    p = nslots // 8
    n_valid_bits = payload_lens * 8
    slot = jax.lax.broadcasted_iota(jnp.int32, (b, nslots), 1)
    bit = 8 * (slot % p) + slot // p
    nbit = bit + ln  # next symbol's bit position
    nslot = jnp.where(nbit < nslots, (nbit % 8) * p + nbit // 8, nslots)
    base = (jnp.arange(b, dtype=jnp.int32) * (nslots + 1))[:, None]
    jump_flat = jnp.concatenate([base + nslot, base + nslots], axis=1).ravel()

    posn = base  # (B,1) local slot 0 == bit 0
    stride = jump_flat
    m = 1
    while m < out_p:
        posn = jnp.concatenate([posn, stride[posn]], axis=1)
        stride = stride[stride]
        m *= 2
    posn = posn[:, :out_p] - base  # local slots, nslots == absorbed

    k = jax.lax.broadcasted_iota(jnp.int32, (b, out_p), 1)
    pos_bit = jnp.where(posn < nslots, 8 * (posn % p) + posn // p, nslots)
    ok = (k < out_counts[:, None]) & (pos_bit < n_valid_bits[:, None])
    flat_sym = ((jnp.arange(b, dtype=jnp.int32) * nslots)[:, None]
                + jnp.minimum(posn, nslots - 1)).ravel()
    out = jnp.where(ok, sym.ravel()[flat_sym].reshape(b, out_p), 0)
    # error flag: requested more symbols than the stream contains
    underrun = jnp.any((k < out_counts[:, None]) & ~ok, axis=1)
    return out.astype(jnp.uint8), underrun


_stage1_jit = jax.jit(decode_stage1)
_stage2_jit = jax.jit(decode_stage2, static_argnames=("out_p",))


def decode_batch(payload: jnp.ndarray, payload_lens: jnp.ndarray,
                 tables: dict, out_counts: jnp.ndarray, out_p: int):
    """(B, P) packed payloads -> ((B, out_p) uint8 symbols, underrun).

    out_p: static padded output size (>= max out_counts in the batch).
    Positions past out_counts are zero; termination is by count, like the
    reference (d.c:530). The two stages are separate jit programs, chained
    through device-resident arrays."""
    ln, sym = _stage1_jit(payload, tables)
    return _stage2_jit(ln, sym, payload_lens, out_counts, out_p=out_p)


def decode_batch_fused(payload, payload_lens, tables, out_counts, out_p):
    """Single-graph composite for shard_map (one jittable callee)."""
    ln, sym = decode_stage1(payload, tables)
    return decode_stage2(ln, sym, payload_lens, out_counts, out_p)
