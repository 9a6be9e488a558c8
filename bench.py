"""Benchmark: compress throughput (modules F+T+C) on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Headline metric: **device-path encode throughput** — input blocks resident
in device memory, through RLE -> histogram -> (host) Shannon-Fano codes ->
bit-pack -> on-device compaction, output payload resident on the device;
the per-block histograms/sizes coming to host and the code LUTs going to
device (KB-scale) are included, as is every device execution. This is the
number that scales with devices and is comparable with the reference's
per-core compute
throughput (BASELINE.md: C ref compresses 100 MB in 1.204 s => 83.1 MB/s
e2e on 2 vCPUs). The end-to-end wall time (file in, sidecar files out) is
reported on stderr.

A full pipeline round trip (compress + decompress + bit-compare) guards
correctness on every run. The run refuses a device that is not a GPU and
exits non-zero when a timed section fails or overruns its time box.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
import sys
import tempfile
import time

import numpy as np

BASELINE_MBPS = 83.1
SIZE = int(os.environ.get("SHAFA_BENCH_SIZE", 100 * 1000 * 1000))
#: decode corpus (a prefix of the encode corpus)
DECODE_SIZE = int(os.environ.get("SHAFA_BENCH_DECODE_SIZE", 64 * 1000 * 1000))
BLOCK_SIZE = int(os.environ.get("SHAFA_BENCH_BLOCK", 8 << 20))
REPS = int(os.environ.get("SHAFA_BENCH_REPS", 3))
#: wall-clock budget: a section that would overrun it fails the run
BUDGET = float(os.environ.get("SHAFA_BENCH_BUDGET", 1100))
_T0 = time.monotonic()


class SectionTimeout(Exception):
    pass


def _remaining() -> float:
    return BUDGET - (time.monotonic() - _T0)


@contextlib.contextmanager
def time_box(seconds: float, name: str):
    """SIGALRM-based box: a section that overruns raises SectionTimeout
    (caught by the caller) instead of eating the whole driver budget."""
    def handler(sig, frm):
        raise SectionTimeout(name)
    old = signal.signal(signal.SIGALRM, handler)
    signal.alarm(max(1, int(seconds)))
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def synthetic(n: int, seed: int = 0) -> bytes:
    """Mixed-entropy corpus: interleaved runs, text-ish bytes, noise."""
    rng = np.random.default_rng(seed)
    parts = []
    total = 0
    while total < n:
        kind = rng.integers(0, 3)
        ln = int(rng.integers(2000, 60000))
        if kind == 0:
            parts.append(np.full(ln, rng.integers(0, 256), np.uint8))
        elif kind == 1:
            parts.append(rng.integers(32, 127, ln).astype(np.uint8))
        else:
            parts.append(rng.integers(0, 256, ln).astype(np.uint8))
        total += ln
    return np.concatenate(parts)[:n].tobytes()


def e2e_roundtrip_check(data: bytes) -> float:
    """Full file->file compress via the real pipeline + decode + compare.
    Returns the e2e compress seconds."""
    from shafa_tpu import pipeline
    from shafa_tpu.device import JaxBackend
    backend = JaxBackend()
    work = tempfile.mkdtemp(prefix="shafa_bench_")
    try:
        path = os.path.join(work, "data.bin")
        with open(path, "wb") as fp:
            fp.write(data)
        t0 = time.perf_counter()
        shaf, (rf, rt, rc) = pipeline.compress_pipeline(
            path, False, False, BLOCK_SIZE, backend)
        dt = time.perf_counter() - t0
        print(f"e2e stages: F={rf.runtime_ms:.0f}ms T={rt.runtime_ms:.0f}ms "
              f"C={rc.runtime_ms:.0f}ms  e2e={dt:.2f}s "
              f"({len(data) / 1e6 / dt:.1f} MB/s)",
              file=sys.stderr)
        os.rename(path, path + ".orig")
        out, _ = pipeline.module_d_shafa(shaf,
                                         rle_decompression=".rle." in shaf,
                                         backend=backend)
        with open(out, "rb") as fp:
            if fp.read() != data:
                raise RuntimeError("round trip mismatch")
        print("round trip bit-exact", file=sys.stderr)
        return dt
    finally:
        shutil.rmtree(work, ignore_errors=True)


def device_encode_seconds(data: bytes) -> float:
    """Device-path F+T+C: blocks on the device -> compacted .shaf payload on
    the device."""
    import jax
    import jax.numpy as jnp

    from shafa_tpu import codes as codes_mod
    from shafa_tpu import geometry
    from shafa_tpu.device import _bucket, _dl_bucket, \
        _row_bucket, _stack_blocks, MAX_BATCH_ELEMS
    from shafa_tpu.kernels import histogram as khist
    from shafa_tpu.kernels import pack as kpack
    from shafa_tpu.kernels import rle as krle

    geo = geometry.geometry_for_size(len(data), BLOCK_SIZE)
    sizes = geo.sizes()
    raw = np.frombuffer(data, np.uint8)
    blocks, pos = [], 0
    for s in sizes:
        blocks.append(raw[pos:pos + s])
        pos += s
    p = _bucket(max(b.size for b in blocks))
    bsz = max(1, MAX_BATCH_ELEMS // p)
    batches = []
    for lo in range(0, len(blocks), bsz):
        rows = blocks[lo:lo + bsz]
        stacked, lens = _stack_blocks(rows, _row_bucket(len(rows), bsz))
        batches.append((jax.block_until_ready(jnp.asarray(stacked)),
                        jnp.asarray(lens), len(rows)))

    def run_once():
        outs = []
        for x, lens, n in batches:
            enc, enc_len = krle.rle_encode_batch(x, lens)
            hist = khist.histogram_batch(enc, enc_len)
            hists = np.asarray(hist)[:n].astype(np.int64)  # tiny download
            tables = codes_mod.build_code_tables(hists)    # host, native C++
            rows = x.shape[0]
            cl = np.zeros((rows, 256), np.int32)
            cv = np.zeros((rows, 256), np.uint32)
            if int(tables.lens.max()) > 32:
                raise RuntimeError("code length > 32 bits: the bench corpus "
                                   "must stay on the device path")
            cl[:n] = tables.lens.astype(np.int32)
            cv[:n] = (tables.vals >> np.uint64(32)).astype(np.uint32)
            flat, _plen = kpack.pack_batch_compact(
                enc, enc_len, jnp.asarray(cl), jnp.asarray(cv), _dl_bucket)
            outs.append(flat)
        return jax.block_until_ready(outs)

    run_once()  # warm (compile)
    t0 = time.perf_counter()
    for _ in range(REPS):
        run_once()
    return (time.perf_counter() - t0) / REPS


def device_decode_seconds(data: bytes, on_rep=None) -> tuple[float, int]:
    """Device-path D: .shaf payloads on the device -> decompressed bytes on
    the device.

    Covers the full decode chain (SF prefix decode + RLE expand + compacted
    output; reference hot loops d.c:514-551 + d.c:116-197). Returns
    (seconds per run, decompressed output bytes). on_rep(secs) is called
    after EVERY timed rep so the first measurement survives a timeout."""
    import jax
    import jax.numpy as jnp

    from shafa_tpu import codes as codes_mod, geometry, oracle
    from shafa_tpu.device import _bucket, _dl_bucket, \
        _row_bucket, _stack_blocks, MAX_BATCH_ELEMS
    from shafa_tpu.kernels import decode as kdecode
    from shafa_tpu.kernels import rle as krle

    # produce the archive on HOST (numpy oracle — byte-identical to the
    # device encoder per the golden tests): keeps the decode section's
    # compile surface to the decode kernels only
    geo = geometry.geometry_for_size(len(data), BLOCK_SIZE)
    raw = np.frombuffer(data, np.uint8)
    blocks, pos = [], 0
    for s in geo.sizes():
        blocks.append(raw[pos:pos + s])
        pos += s
    import concurrent.futures as cf
    with cf.ThreadPoolExecutor() as ex:  # numpy releases the GIL
        enc_blocks = list(ex.map(oracle.rle_encode, blocks))
        hists = np.stack(list(ex.map(oracle.histogram, enc_blocks))) \
            .astype(np.int64)
        tables = codes_mod.build_code_tables(hists)
        payloads = list(ex.map(
            lambda ie: oracle.pack(ie[1], tables.lens[ie[0]],
                                   tables.vals[ie[0]]),
            enumerate(enc_blocks)))
    counts = [e.size for e in enc_blocks]

    pblocks = [np.frombuffer(p, np.uint8) for p in payloads]
    p = _bucket(max(b.size for b in pblocks))
    bsz = max(1, MAX_BATCH_ELEMS // (p * 2))  # match device.py's decode cap
    tab_all = kdecode.decode_tables_batch(tables.lens, tables.vals)
    batches = []
    for lo in range(0, len(pblocks), bsz):
        rows = pblocks[lo:lo + bsz]
        nb = len(rows)
        b_rows = _row_bucket(nb, bsz)
        stacked, plens = _stack_blocks(rows, b_rows)
        cts = np.zeros(b_rows, np.int32)
        cts[:nb] = counts[lo:lo + nb]
        tab = {}
        for k, v in tab_all.items():
            pad = np.zeros((b_rows,) + v.shape[1:], v.dtype)
            pad[:nb] = v[lo:lo + nb]
            if b_rows > nb:
                pad[nb:] = v[lo:lo + 1]
            tab[k] = pad
        batches.append((jax.block_until_ready(jnp.asarray(stacked)),
                        jnp.asarray(plens), tab, jnp.asarray(cts), nb))
    out_p = _bucket(max(counts))

    def run_once():
        outs = []
        for stacked, plens, tab, cts, nb in batches:
            dec, _under = kdecode.decode_batch(stacked, plens, tab, cts,
                                               out_p=out_p)
            sizes = np.asarray(krle.rle_expand_sizes(dec, cts)).copy()
            sizes[nb:] = 0
            outs.append(krle.rle_expand_compact(
                dec, cts, out_sz=_dl_bucket(int(sizes.sum()))))
        return jax.block_until_ready(outs)

    run_once()  # warm (compile)
    best = None
    for _ in range(REPS):
        t0 = time.perf_counter()
        run_once()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
        if on_rep is not None:
            on_rep(best)
    return best, len(data)


def emit_json(mbps: float, extra: dict) -> None:
    """The result line, re-printed (a superset) after each later section."""
    print(json.dumps({
        "metric": "encode_throughput_device",
        "value": round(mbps, 2),
        "unit": "MB/s",
        "vs_baseline": round(mbps / BASELINE_MBPS, 2),
        **extra,
    }), flush=True)


def main() -> int:
    import jax

    from shafa_tpu import compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    compile_cache.enable()
    data = synthetic(SIZE)
    extra = {"platform": dev.platform, "device_kind": dev.device_kind,
             "device_count": len(jax.devices())}

    # 1. headline FIRST — everything else is additive
    dt = device_encode_seconds(data)
    mbps = SIZE / 1e6 / dt
    print(f"device encode: {dt:.3f}s = {mbps:.1f} MB/s", file=sys.stderr)
    emit_json(mbps, extra)

    failed = []
    # 2. device decode throughput (time-boxed; the first rep's number is
    # emitted immediately and refined by later reps)
    if os.environ.get("SHAFA_BENCH_DECODE", "1") != "0":
        ddata = data[:DECODE_SIZE]

        def on_rep(secs):
            dmbps = len(ddata) / 1e6 / secs
            extra["decode_mb_s"] = round(dmbps, 2)
            extra["decode_vs_c_ref"] = round(dmbps / 86.0, 2)
            emit_json(mbps, extra)

        try:
            with time_box(_remaining() - 20, "decode"):
                ddt, out_bytes = device_decode_seconds(ddata, on_rep)
            print(f"device decode: {ddt:.3f}s = "
                  f"{out_bytes / 1e6 / ddt:.1f} MB/s out "
                  f"(C ref: 86 MB/s)", file=sys.stderr)
        except SectionTimeout:
            failed.append("decode")

    # 3. correctness guard: full file->file round trip through the CLI
    # pipeline
    e2e_size = int(os.environ.get("SHAFA_BENCH_E2E_SIZE",
                                  min(SIZE, 16 * 1000 * 1000)))
    try:
        with time_box(_remaining() - 15, "e2e"):
            t0 = time.perf_counter()
            e2e_roundtrip_check(data[:e2e_size])
            print(f"e2e+roundtrip ({e2e_size / 1e6:.0f} MB): "
                  f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)
            extra["roundtrip_bit_exact"] = True
            emit_json(mbps, extra)
    except SectionTimeout:
        failed.append("e2e")

    # 4. streaming-overlap ratio: bounded-RSS streaming compress (file ->
    # .rle/.freq/.cod/.shaf on disk, read-ahead/write-behind) vs the pure
    # device encode rate measured in section 1. Page-cached input file, so
    # the ratio isolates pipeline/IO overlap quality, not disk speed.
    if os.environ.get("SHAFA_BENCH_STREAM", "1") != "0":
        try:
            with time_box(_remaining() - 15, "streaming"):
                sdt = streaming_seconds(data)
            smbps = SIZE / 1e6 / sdt
            extra["streaming_e2e_mb_s"] = round(smbps, 2)
            extra["streaming_vs_device"] = round(smbps / mbps, 2)
            print(f"streaming e2e: {sdt:.2f}s = {smbps:.1f} MB/s "
                  f"({100 * smbps / mbps:.0f}% of device rate)",
                  file=sys.stderr)
            emit_json(mbps, extra)
        except SectionTimeout:
            failed.append("streaming")

    if failed:
        print(f"sections that overran their time box: {failed}",
              file=sys.stderr)
        return 1
    return 0


def streaming_seconds(data: bytes) -> float:
    """Seconds for the streaming-tier compress of data (file to sidecars)."""
    from shafa_tpu import pipeline
    from shafa_tpu.device import JaxBackend
    work = tempfile.mkdtemp(prefix="shafa_stream_")
    try:
        spath = os.path.join(work, "s.bin")
        with open(spath, "wb") as fp:
            fp.write(data)
        old_thr = pipeline.STREAM_THRESHOLD
        pipeline.STREAM_THRESHOLD = 1  # force streaming tier
        try:
            t0 = time.perf_counter()
            pipeline.compress_pipeline_streaming(
                spath, False, False, BLOCK_SIZE, JaxBackend())
            return time.perf_counter() - t0
        finally:
            pipeline.STREAM_THRESHOLD = old_thr
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
