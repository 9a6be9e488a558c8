"""Fused device-resident chain vs sequential modules: byte-identical files.

compress_pipeline/fused_decode must produce exactly the bytes of module_f ->
module_t -> module_c (and module_d with the per-stage backend API); the
fused path only changes where intermediate streams live (device HBM vs
host), never the output (SURVEY.md §2.1 contract).
"""

import os

import numpy as np
import pytest

from shafa_tpu import pipeline
from shafa_tpu.device import JaxBackend
from shafa_tpu.pipeline import NumpyBackend

from corpus import mixed


def _files(d):
    return sorted(os.listdir(d))


def _run_compress(tmp, name, data, backend, fused, force_rle=False,
                  force_freq=False):
    sub = tmp / name
    sub.mkdir()
    path = str(sub / "data.bin")
    with open(path, "wb") as fp:
        fp.write(data)
    if fused:
        pipeline.compress_pipeline(path, force_rle, force_freq, 64 << 10,
                                   backend)
    else:
        p, _ = pipeline.module_f(path, force_rle, force_freq, 64 << 10,
                                 backend)
        p, _ = pipeline.module_t(p)
        pipeline.module_c(p, backend)
    return sub


@pytest.mark.parametrize("force_flags", [(False, False), (True, True)])
def test_fused_compress_matches_sequential(tmp_path, force_flags):
    data = mixed(300_000, seed=11)
    jb = JaxBackend()
    assert jb.supports_fused
    a = _run_compress(tmp_path, "fused", data, jb, True, *force_flags)
    b = _run_compress(tmp_path, "seq", data, NumpyBackend(), False,
                      *force_flags)
    assert _files(a) == _files(b)
    for f in _files(a):
        with open(a / f, "rb") as fa, open(b / f, "rb") as fb:
            assert fa.read() == fb.read(), f


def test_fused_compress_incompressible(tmp_path):
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 200_000).astype(np.uint8).tobytes()
    a = _run_compress(tmp_path, "fused", data, JaxBackend(), True)
    b = _run_compress(tmp_path, "seq", data, NumpyBackend(), False)
    assert _files(a) == _files(b)  # N-mode: .freq + .cod + .shaf, no .rle
    for f in _files(a):
        with open(a / f, "rb") as fa, open(b / f, "rb") as fb:
            assert fa.read() == fb.read(), f


def test_fused_decode_roundtrip(tmp_path):
    data = mixed(400_000, seed=12)
    jb = JaxBackend()
    sub = _run_compress(tmp_path, "rt", data, jb, True)
    shaf = next(f for f in _files(sub) if f.endswith(".shaf"))
    out, _ = pipeline.module_d_shafa(str(sub / shaf),
                                     rle_decompression=".rle." in shaf,
                                     backend=jb)
    with open(out, "rb") as fp:
        assert fp.read() == data


def test_fused_decode_mixed_code_widths(tmp_path):
    # fused_decode decodes blocks with codes over 16 bits apart from the
    # rest (their longer payloads would pad the whole batch); both groups
    # must land back in block order.
    from shafa_tpu import codes as codes_mod, oracle

    rng = np.random.default_rng(55)
    a = rng.integers(0, 256, 4000, dtype=np.uint8)        # broad: <= 16 bits
    lens_list = list(range(1, 18)) + [18, 18]             # max len 18 bits
    lens = np.zeros((2, 256), np.uint8)
    vals = np.zeros((2, 256), np.uint64)
    ta = codes_mod.build_code_tables(
        np.stack([oracle.histogram(a)]).astype(np.int64))
    lens[0], vals[0] = ta.lens[0], ta.vals[0]
    code = prev = 0
    for s, ln in enumerate(lens_list):
        code <<= ln - prev
        lens[1, s] = ln
        vals[1, s] = np.uint64(code) << np.uint64(64 - ln)
        code += 1
        prev = ln
    tables = codes_mod.CodeTables(lens, vals)
    assert int(tables.lens[0].max()) <= 16 < int(tables.lens[1].max())
    b = rng.integers(0, len(lens_list), 4000).astype(np.uint8)
    payloads = [oracle.pack(a, lens[0], vals[0]),
                oracle.pack(b, lens[1], vals[1])]
    jb = JaxBackend()
    out = jb.fused_decode(payloads, tables, [a.size, b.size], expand=False)
    np.testing.assert_array_equal(out[0], a)
    np.testing.assert_array_equal(out[1], b)
