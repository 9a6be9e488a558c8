"""Boundary cases of the XLA decode, expand, compaction and pack kernels,
differential against the numpy oracle (oracle.unpack / rle_expand / pack).

Shapes the CPU tests elsewhere do not reach: all-8-bit and 16-bit-boundary
code tables, codes of 17-32 bits, 1-bit codes at 8 symbols per payload byte,
partial counts and underrun, escape runs that expand 85x, rows that end
mid-word beside long rows, zero-length rows, and payloads of many KiB.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from shafa_tpu import codes as codes_mod, oracle
from shafa_tpu.device import _bucket, _dl_bucket, _stack_blocks
from shafa_tpu.kernels import decode as kdecode
from shafa_tpu.kernels import ops as kops
from shafa_tpu.kernels import pack as kpack
from shafa_tpu.kernels import rle as krle


def _canonical(max_len: int) -> codes_mod.CodeTables:
    """One complete canonical code table with lengths 1..max_len-1 plus two
    codes of max_len (Kraft sum exactly 1)."""
    lens_list = list(range(1, max_len)) + [max_len, max_len]
    lens = np.zeros((1, 256), np.uint8)
    vals = np.zeros((1, 256), np.uint64)
    code = prev = 0
    for s, ln in enumerate(lens_list):
        code <<= ln - prev
        lens[0, s] = ln
        vals[0, s] = np.uint64(code) << np.uint64(64 - ln)
        code += 1
        prev = ln
    return codes_mod.CodeTables(lens, vals)


def _archive(blocks):
    hists = np.stack([oracle.histogram(b) for b in blocks])
    tables = codes_mod.build_code_tables(hists)
    payloads = [oracle.pack(b, tables.lens[i], tables.vals[i])
                for i, b in enumerate(blocks)]
    return tables, payloads


def _decode(payloads, tables, counts):
    pblocks = [np.frombuffer(p, np.uint8) for p in payloads]
    stacked, plens = _stack_blocks(pblocks)
    tab = kdecode.decode_tables_batch(tables.lens, tables.vals)
    out, under = kdecode.decode_batch(
        jnp.asarray(stacked), jnp.asarray(plens), tab,
        jnp.asarray(np.array(counts, np.int32)), _bucket(int(max(counts))))
    return np.asarray(out), np.asarray(under)


def _decode_matches(blocks, tables=None):
    if tables is None:
        tables, payloads = _archive(blocks)
    else:
        payloads = [oracle.pack(b, tables.lens[0], tables.vals[0])
                    for b in blocks]
    counts = [b.size for b in blocks]
    out, under = _decode(payloads, tables, counts)
    assert not under.any()
    for i, b in enumerate(blocks):
        np.testing.assert_array_equal(out[i, :counts[i]], b,
                                      err_msg=f"row {i}")
    return tables


# --- SF decode (decode_batch) ----------------------------------------------

def test_decode_mixed_rows():
    rng = np.random.default_rng(41)
    _decode_matches([
        rng.integers(0, 256, 3000, dtype=np.uint8),            # broad
        np.repeat(rng.integers(0, 5, 700), 3).astype(np.uint8)[:2000],
        rng.integers(97, 102, 1500).astype(np.uint8),          # tiny alphabet
    ])


def test_decode_skewed_long_codes():
    # geometric-ish skew drives code lengths past 8 and 16 bits
    rng = np.random.default_rng(42)
    b0 = np.concatenate([np.full(1 << max(0, 12 - s), s, np.uint8)
                         for s in range(40)])
    rng.shuffle(b0)
    tables = _decode_matches([b0])
    assert int(tables.lens.max()) > 8


def test_decode_all_8bit_codes():
    # uniform 256-symbol data: every symbol gets exactly 8 bits
    rng = np.random.default_rng(45)
    b0 = np.tile(np.arange(256, dtype=np.uint8), 16)
    rng.shuffle(b0)
    tables = _decode_matches([b0])
    nz = tables.lens[0][tables.lens[0] > 0]
    assert int(nz.max()) == 8 and int(nz.min()) == 8


@pytest.mark.parametrize("max_len,seed", [(16, 46), (20, 49), (32, 50)])
def test_decode_canonical_code_width(max_len, seed):
    # longest code exactly 16 bits, 17-32 bits, and the full 32-bit width
    # (windows whose low bits come from the fourth byte after the start)
    tables = _canonical(max_len)
    rng = np.random.default_rng(seed)
    n_sym = max_len + 1
    b0 = rng.integers(0, n_sym, 5000).astype(np.uint8)
    b0[::97] = n_sym - 1  # make sure the longest codes occur
    _decode_matches([b0], tables)


def test_decode_one_bit_codes():
    # 2-symbol table -> 1-bit codes: 8 output bytes per payload byte
    rng = np.random.default_rng(48)
    b0 = np.where(rng.random(60000) < 0.5, 65, 66).astype(np.uint8)
    tables = _decode_matches([b0])
    assert int(tables.lens[0].max()) == 1


def test_decode_partial_count():
    rng = np.random.default_rng(43)
    b0 = rng.integers(0, 256, 2048, dtype=np.uint8)
    tables, payloads = _archive([b0])
    out, under = _decode(payloads, tables, [1000])  # fewer than available
    assert not under.any()
    np.testing.assert_array_equal(out[0, :1000], b0[:1000])


def test_decode_underrun_truncated_payload():
    rng = np.random.default_rng(44)
    b0 = rng.integers(0, 256, 2048, dtype=np.uint8)
    tables, payloads = _archive([b0])
    truncated = payloads[0][: len(payloads[0]) // 2]
    _, under = _decode([truncated], tables, [b0.size])
    assert bool(under[0])


# --- RLE expand + compaction -----------------------------------------------

def _rle_stream(rng, n):
    """A valid RLE stream of about n bytes (whole escape triples only)."""
    out = bytearray()
    while len(out) < n:
        if rng.random() < 0.4:
            out += bytes([0, int(rng.integers(0, 256)),
                          int(rng.integers(0, 256))])
        else:
            out.append(int(rng.integers(1, 256)))
    return np.frombuffer(bytes(out), np.uint8)


def _expand_matches(rows):
    x, lens = _stack_blocks(rows)
    sizes = np.asarray(krle.rle_expand_sizes(jnp.asarray(x),
                                             jnp.asarray(lens)))
    want = [oracle.rle_expand(r) for r in rows]
    np.testing.assert_array_equal(sizes, [w.size for w in want])
    total = int(sizes.sum())
    flat = np.asarray(krle.rle_expand_compact(
        jnp.asarray(x), jnp.asarray(lens), out_sz=_dl_bucket(total)))
    np.testing.assert_array_equal(flat[:total], np.concatenate(want))
    assert not flat[total:].any()


@pytest.mark.parametrize("case", [
    "literals", "escapes", "multi_row", "big_runs", "short_then_long",
    "empty_and_tiny"])
def test_expand_compact(case):
    rng = np.random.default_rng(0)
    rows = {
        "literals": [np.arange(1, 200, dtype=np.uint8)],
        "escapes": [np.frombuffer(b"\x00A\xff\x00B\x04\x00\x00\x01C",
                                  np.uint8)],
        "multi_row": [_rle_stream(rng, int(rng.integers(300, 5000)))
                      for _ in range(5)],
        # escapes expanding to 255 each: output 85x the input
        "big_runs": [np.frombuffer(b"".join(
            bytes([0, s % 256, 255]) for s in range(1, 200)), np.uint8)] * 2,
        # a row ending mid-word beside a long row: no bytes may leak
        "short_then_long": [np.frombuffer(b"\x00Q\x07", np.uint8),
                            np.frombuffer(b"\x00Z\xff" * 40, np.uint8)],
        # zero-length row, one literal, a zero-count escape of 0x00 (-> 1)
        "empty_and_tiny": [np.zeros(0, np.uint8),
                           np.frombuffer(b"A", np.uint8),
                           np.frombuffer(b"\x00\x00\x00", np.uint8)],
    }[case]
    _expand_matches(rows)


def test_compact_rows_ragged():
    rng = np.random.default_rng(3)
    b, q = 6, 3000
    rows = rng.integers(0, 256, (b, q), dtype=np.uint8)
    lens = np.array([3000, 0, 1, 2999, 17, 1024], np.int32)
    total = int(lens.sum())
    flat = np.asarray(kops.compact_rows(jnp.asarray(rows), jnp.asarray(lens),
                                        out_sz=total + 123))
    want = np.concatenate([rows[i, :lens[i]] for i in range(b)])
    np.testing.assert_array_equal(flat[:total], want)
    assert not flat[total:].any()


# --- bit-pack (pack_batch_compact) -----------------------------------------

def _pack_matches(blocks, tables):
    stacked, lens = _stack_blocks(blocks)
    cl = tables.lens.astype(np.int32)
    cv = (tables.vals >> np.uint64(32)).astype(np.uint32)
    flat, plen = kpack.pack_batch_compact(stacked, lens, cl, cv, _dl_bucket)
    flat = np.asarray(flat)
    pos = 0
    for i, b in enumerate(blocks):
        want = oracle.pack(b, tables.lens[i], tables.vals[i])
        assert int(plen[i]) == len(want), f"row {i}"
        assert flat[pos:pos + len(want)].tobytes() == want, f"row {i}"
        pos += len(want)
    assert not flat[pos:].any()


def _rows_of(table: codes_mod.CodeTables, n: int) -> codes_mod.CodeTables:
    return codes_mod.CodeTables(np.repeat(table.lens, n, 0),
                                np.repeat(table.vals, n, 0))


def test_pack_one_bit_codes():
    rng = np.random.default_rng(8)
    b0 = np.where(rng.random(9000) < 0.3, 7, 200).astype(np.uint8)
    tables, _ = _archive([b0])
    assert int(tables.lens[0].max()) == 1
    _pack_matches([b0], tables)


def test_pack_32_bit_codes():
    tables = _canonical(32)
    rng = np.random.default_rng(9)
    b0 = rng.integers(0, 33, 4000).astype(np.uint8)
    b0[::50] = 32  # the two 32-bit codes
    b0[1::50] = 31
    _pack_matches([b0, b0[:1001]], _rows_of(tables, 2))


def test_pack_ragged_rows_with_empty_row():
    rng = np.random.default_rng(10)
    x = rng.integers(0, 256, 1500, dtype=np.uint8)
    x[:700] = 7  # skewed histogram -> longer codes
    blocks = [x, x[:0], x[:1300], x[:64]]
    tables, _ = _archive([x] * 4)
    _pack_matches(blocks, tables)


def test_pack_rows_longer_than_a_page():
    # > 8 KiB of packed bytes per row, several rows
    rng = np.random.default_rng(11)
    blocks = [rng.integers(0, 256, 30000, dtype=np.uint8),
              rng.integers(0, 64, 20000).astype(np.uint8),
              rng.integers(0, 256, 12289, dtype=np.uint8)]
    tables, _ = _archive(blocks)
    _pack_matches(blocks, tables)


def test_pack_shannon_fano_tables_vs_oracle():
    from corpus import runs_heavy, text
    blocks = [np.frombuffer(text(20000, 3), np.uint8),
              oracle.rle_encode(runs_heavy(30000, 4))]
    tables, _ = _archive(blocks)
    _pack_matches(blocks, tables)
