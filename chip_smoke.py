"""Smoke run of the codec's main path on a GPU, through its user entry points.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # the block-parallel archive on four cards

One card (the first visible one, even when more are visible):
  * a 100 MB seeded mixed-entropy corpus (bench.synthetic; BASELINE.json
    config 2) compressed (F->T->C) and decompressed (D) by ``cli.main`` in
    this process at ``-b m`` and at ``-b M``, cold (compiling) and warm, with
    a bit-exact round trip each time;
  * oracle parity: the first 24 MiB at ``-b m``, every sidecar byte-identical
    to what ``--backend numpy`` writes;
  * no block of any archive qualifies for the host oracle (oracle_blocks);
  * per-stage device times, each fenced by jax.block_until_ready.

``--four`` runs only the mesh path: the same 100 MB at ``-b m`` through
``cli.main`` with four cards visible (the CLI shards blocks over all local
devices), compared byte for byte with a one-card ``JaxBackend`` run, then
decompressed on the mesh.

Exits non-zero, printing no result, unless JAX's first device is a GPU. The
last line of stdout is one JSON object: {"ok": ..., "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

from bench import synthetic
from shafa_tpu import cli, compile_cache, device, formats, pipeline, runtime

CORPUS_BYTES = 100 * 1000 * 1000
PARITY_BYTES = 24 << 20
SEED = 0


def oracle_blocks(cod_path: str) -> list[int]:
    """Blocks of an archive that the device path hands to the host oracle
    (device.pack_on_device / decode_on_device), read from its .cod."""
    with open(cod_path, "rb") as fp:
        _mode, sizes, tables = formats.parse_cod_tables(fp.read())
    ok = device.pack_on_device(tables, sizes) & device.decode_on_device(tables)
    return [int(i) for i in np.flatnonzero(~ok)]


def _cli(args: list[str]) -> float:
    """cli.main(args) in this process; its summaries go to stderr. Returns
    the wall seconds; raises on a non-zero exit."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli.main(args)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main({args}) exited {rc}")
    return dt


def _archive(path: str) -> str:
    for ext in (formats.RLE_EXT + formats.SHAFA_EXT, formats.SHAFA_EXT):
        if os.path.exists(path + ext):
            return path + ext
    raise FileNotFoundError(f"no .shaf beside {path}")


def roundtrip(data: bytes, flag: str, work: str, runs: int = 2) -> None:
    """Compress + decompress data through cli.main at -b flag, `runs` times
    (the first compiles); bit-exact each time, no block on the oracle."""
    path = os.path.join(work, "data.bin")
    mb = len(data) / 1e6
    for run in range(runs):
        label = "cold" if run == 0 else "warm"
        with open(path, "wb") as fp:
            fp.write(data)
        tc = _cli([path, "-b", flag])
        shaf = _archive(path)
        os.remove(path)
        td = _cli([shaf])
        with open(path, "rb") as fp:
            if fp.read() != data:
                raise RuntimeError(f"-b {flag} {label}: round trip differs")
        print(f"-b {flag} {label}: compress {mb / tc:.2f} MB/s ({tc:.3f} s), "
              f"decompress {mb / td:.2f} MB/s ({td:.3f} s), bit-exact")
    bad = oracle_blocks(shaf[: -len(formats.SHAFA_EXT)] + formats.CODES_EXT)
    if bad:
        raise RuntimeError(f"-b {flag}: blocks {bad} qualify for the oracle")
    print(f"-b {flag}: no block on the host oracle")


def _sidecars(d: str) -> dict[str, bytes]:
    out = {}
    for name in sorted(os.listdir(d)):
        if name != "data.bin":
            with open(os.path.join(d, name), "rb") as fp:
                out[name] = fp.read()
    return out


def oracle_parity(data: bytes, work: str) -> None:
    """Sidecars of the device path == sidecars of --backend numpy."""
    dirs = {}
    for backend in ("jax", "numpy"):
        d = dirs[backend] = os.path.join(work, backend)
        os.makedirs(d)
        path = os.path.join(d, "data.bin")
        with open(path, "wb") as fp:
            fp.write(data)
        _cli([path, "-b", "m", "--backend", backend])
    got, want = _sidecars(dirs["jax"]), _sidecars(dirs["numpy"])
    if list(got) != list(want):
        raise RuntimeError(f"sidecar sets differ: {list(got)} {list(want)}")
    for name in want:
        if got[name] != want[name]:
            raise RuntimeError(f"{name}: device != numpy oracle")
    cod = next(n for n in want if n.endswith(formats.CODES_EXT))
    bad = oracle_blocks(os.path.join(dirs["jax"], cod))
    if bad:
        raise RuntimeError(f"parity: blocks {bad} qualify for the oracle")
    print(f"oracle parity ({len(data)} B, -b m): {', '.join(want)} "
          f"byte-identical to --backend numpy")


def stage_times(data: bytes, block_size: int) -> None:
    """Warm device time of each stage of the F->C and D chains, in the
    batches device.JaxBackend forms, each call fenced by block_until_ready."""
    import jax
    import jax.numpy as jnp

    from shafa_tpu import codes as codes_mod, geometry
    from shafa_tpu.kernels import decode as kdecode
    from shafa_tpu.kernels import histogram as khist
    from shafa_tpu.kernels import pack as kpack
    from shafa_tpu.kernels import rle as krle

    stage1 = jax.jit(kdecode.decode_stage1)
    stage2 = jax.jit(kdecode.decode_stage2, static_argnames="out_p")
    times: dict[str, float] = {}

    def timed(name, fn, *args, **kw):
        jax.block_until_ready(fn(*args, **kw))  # compile + warm
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        return out

    raw = np.frombuffer(data, np.uint8)
    sizes = geometry.geometry_for_size(len(data), block_size).sizes()
    bounds = np.concatenate(([0], np.cumsum(sizes)))
    blocks = [raw[bounds[i]:bounds[i + 1]] for i in range(len(sizes))]
    bsz = max(1, device.MAX_BATCH_ELEMS // device._bucket(block_size))
    for lo in range(0, len(blocks), bsz):
        rows = blocks[lo:lo + bsz]
        n = len(rows)
        stacked, lens = device._stack_blocks(
            rows, device._row_bucket(n, bsz))
        x, ld = jnp.asarray(stacked), jnp.asarray(lens)
        enc, enc_len = timed("rle encode", krle.rle_encode_batch, x, ld)
        hist = timed("histogram", khist.histogram_batch, enc, enc_len)
        tables = codes_mod.build_code_tables(
            np.asarray(hist)[:n].astype(np.int64))
        cl = np.zeros((x.shape[0], 256), np.int32)
        cv = np.zeros((x.shape[0], 256), np.uint32)
        cl[:n] = tables.lens
        cv[:n] = (tables.vals >> np.uint64(32)).astype(np.uint32)
        flat, plen = timed("pack + compaction", kpack.pack_batch_compact,
                           enc, enc_len, cl, cv, device._dl_bucket)
        flat = np.asarray(flat)
        pbounds = np.concatenate(([0], np.cumsum(plen)))
        payloads = [flat[pbounds[i]:pbounds[i + 1]] for i in range(n)]
        pstack, plens = device._stack_blocks(payloads, x.shape[0])
        tab = kdecode.decode_tables_batch(tables.lens, tables.vals)
        tab = {k: np.concatenate([v] + [v[:1]] * (x.shape[0] - n))
               for k, v in tab.items()}
        counts = np.asarray(enc_len).astype(np.int32)
        counts[n:] = 0
        out_p = device._bucket(int(counts.max()))
        ln, sym = timed("decode stage 1", stage1, jnp.asarray(pstack), tab)
        dec, under = timed("decode stage 2", stage2, ln, sym, plens, counts,
                           out_p=out_p)
        del ln, sym
        if bool(np.asarray(under)[:n].any()):
            raise RuntimeError("stage times: decode underrun")
        ex_sizes = np.asarray(timed("expand sizes", krle.rle_expand_sizes,
                                    dec, counts))
        total = int(ex_sizes.sum())
        out = timed("expand + compaction", krle.rle_expand_compact, dec,
                    jnp.asarray(counts), out_sz=device._dl_bucket(total))
        if np.asarray(out)[:total].tobytes() != b"".join(
                r.tobytes() for r in rows):
            raise RuntimeError("stage times: expanded bytes differ")
    mb = len(data) / 1e6
    for name, secs in times.items():
        print(f"stage {name}: {secs * 1e3:.2f} ms "
              f"({mb / secs:.1f} MB/s of input, {len(blocks)} blocks)")


def mesh_archive(data: bytes, work: str) -> None:
    """cli.main's auto-mesh archive == a one-device JaxBackend archive;
    decompression on the mesh is bit-exact; shards sit on distinct
    devices."""
    import jax

    backend = cli._make_backend(cli.Options(backend="jax"))
    n_dev = len(jax.local_devices())
    if backend._sk is None or backend._sk.n_devices != n_dev:
        raise RuntimeError("the CLI backend does not span every device")
    h = backend.fused_encode(
        [np.frombuffer(data[:8 << 20], np.uint8)] * n_dev)
    enc = h.batches[0]["enc"]
    placed = sorted({str(s.device) for s in enc.addressable_shards})
    print(f"mesh shards of one batch sit on {len(placed)} devices: {placed}")
    if len(placed) != n_dev:
        raise RuntimeError("shards do not span every device")
    del h, enc

    mesh_dir, one_dir = (os.path.join(work, d) for d in ("mesh", "one"))
    for d in (mesh_dir, one_dir):
        os.makedirs(d)
        with open(os.path.join(d, "data.bin"), "wb") as fp:
            fp.write(data)
    tc = _cli([os.path.join(mesh_dir, "data.bin"), "-b", "m"])
    t0 = time.perf_counter()
    pipeline.compress_pipeline(os.path.join(one_dir, "data.bin"), False,
                               False, 8 << 20, device.JaxBackend())
    t1 = time.perf_counter() - t0
    got, want = _sidecars(mesh_dir), _sidecars(one_dir)
    if list(got) != list(want):
        raise RuntimeError(f"sidecar sets differ: {list(got)} {list(want)}")
    for name in want:
        if got[name] != want[name]:
            raise RuntimeError(f"{name}: {n_dev}-device mesh != one device")
    mb = len(data) / 1e6
    print(f"mesh archive ({n_dev} devices, -b m): {', '.join(want)} "
          f"byte-identical to one device; compress {mb / tc:.2f} MB/s "
          f"on the mesh, {mb / t1:.2f} MB/s on one device (both cold)")
    path = os.path.join(mesh_dir, "data.bin")
    shaf = _archive(path)
    os.remove(path)
    td = _cli([shaf])
    with open(path, "rb") as fp:
        if fp.read() != data:
            raise RuntimeError("mesh decompression differs")
    print(f"mesh decompress: {mb / td:.2f} MB/s (cold), bit-exact")


def _card_lines() -> list[str]:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the block-parallel archive on 4 cards")
    four = ap.parse_args().four

    import jax
    if not four:
        jax.config.update("jax_cuda_visible_devices", "0")
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 2
    if four and len(devs) != 4:
        print(f"chip_smoke --four: needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    print(f"compile cache: {compile_cache.enable()}")
    print("nvidia-smi name, power.limit:")
    for line in _card_lines():
        print(line)
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    print(f"native runtime loaded: {runtime.available()}")

    data = synthetic(CORPUS_BYTES, SEED)
    if four:
        phases = [("mesh archive", lambda w: mesh_archive(data, w))]
    else:
        phases = [
            ("round trip -b m", lambda w: roundtrip(data, "m", w)),
            ("oracle parity", lambda w: oracle_parity(data[:PARITY_BYTES], w)),
            ("round trip -b M", lambda w: roundtrip(data, "M", w)),
            ("stage times", lambda w: stage_times(data, 8 << 20)),
        ]
    failed = []
    for name, phase in phases:
        work = tempfile.mkdtemp(prefix="shafa_smoke_")
        t0 = time.perf_counter()
        try:
            phase(work)
        except Exception:
            traceback.print_exc()
            failed.append(name)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(f"phase {name}: {'FAILED' if name in failed else 'ok'} "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
    stats = devs[0].memory_stats() or {}
    print(f"peak device memory: {stats.get('peak_bytes_in_use', 0)} B")
    if failed:
        print(f"failed phases: {failed}")
    print(json.dumps({"ok": not failed, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
