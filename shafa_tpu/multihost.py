"""Multi-host execution: network scale-out of the block-parallel codec.

The reference is single-process (SURVEY.md §5.8: no MPI/NCCL/sockets — the
pthread join chain is its whole communication layer). The device
equivalent for N hosts x M devices:

  * hosts join one JAX runtime via ``jax.distributed.initialize`` (env-driven:
    COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID; see init_from_env);
  * blocks are partitioned into CONTIGUOUS per-host ranges in block order —
    the reference's ordered-write guarantee (multithread.c:79) becomes a
    deterministic block->host map plus offset-addressed writes;
  * each host reads only its byte range of the input and encodes it locally
    (single-host fused path over its local devices);
  * the only cross-host exchanges are KB-scale: per-block sizes and 256-bin
    histograms, all-gathered so every host can (a) compute the byte offset
    of its output shard and (b) build identical .cod tables;
  * every host pwrites its own shard of .rle/.shaf at its computed offset
    into the shared file (a shared file system is assumed); host 0 writes
    the tiny ASCII sidecars (.freq/.cod) and headers.

Tested by running the partition/splice machinery with a simulated
(process_index, process_count) in one process (tests/test_multihost.py) —
the same code path a real cluster takes, minus the network transport,
which is jax.distributed's responsibility.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from . import codes as codes_mod
from . import formats, geometry
from .errors import FileInaccessibleError, FileTooSmallError


def init_from_env() -> None:
    """Join the multi-process runtime from COORDINATOR_ADDRESS,
    NUM_PROCESSES and PROCESS_ID.

    A coordinator on a loopback address is reachable only from this host,
    so every process shares the host: each then takes one local device,
    the one numbered by its PROCESS_ID, instead of all of them. Otherwise
    each host runs one process over all its local devices.

    Must run before ANY backend-initializing jax call (jax.devices etc.)."""
    import jax
    if jax.distributed.is_initialized():
        return
    addr = os.environ["COORDINATOR_ADDRESS"]
    pid = int(os.environ["PROCESS_ID"])
    host = addr.rsplit(":", 1)[0].strip("[]")
    shared_host = host in ("localhost", "::1") or host.startswith("127.")
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=int(os.environ["NUM_PROCESSES"]),
        process_id=pid,
        local_device_ids=[pid] if shared_host else None)


@dataclasses.dataclass(frozen=True)
class BlockRange:
    """Contiguous block range [lo, hi) owned by one host."""
    lo: int
    hi: int

    @property
    def n(self) -> int:
        return self.hi - self.lo


def partition_blocks(n_blocks: int, process_count: int,
                     process_index: int) -> BlockRange:
    """Contiguous, balanced split: host h owns blocks [h*n//H, (h+1)*n//H).

    Contiguity keeps every host's input read and output write a single
    extent, and makes ordered reassembly pure offset arithmetic."""
    lo = n_blocks * process_index // process_count
    hi = n_blocks * (process_index + 1) // process_count
    return BlockRange(lo, hi)


class Comm:
    """Host-level communication: process identity + small-array all-gather.

    The production implementation rides jax.distributed; tests inject
    a thread-barrier implementation to simulate N hosts in one process
    (tests/test_multihost.py) — the codec logic is identical either way.
    """

    @property
    def index(self) -> int:
        import jax
        return jax.process_index()

    @property
    def count(self) -> int:
        import jax
        return jax.process_count()

    def allgather(self, local: np.ndarray) -> np.ndarray:
        """Concatenate each host's array along axis 0, process order.

        Handles RAGGED per-host row counts (n_blocks rarely divides the
        host count): a scalar-length gather first, then a padded gather and
        per-host slicing. Only KB-scale metadata (sizes, histograms) ever
        crosses hosts."""
        local = np.asarray(local)
        if self.count <= 1:
            return local
        from jax.experimental import multihost_utils as mhu
        ns = np.asarray(mhu.process_allgather(
            np.array([local.shape[0]], np.int64), tiled=True)).ravel()
        m = int(ns.max())
        pad = np.zeros((m,) + local.shape[1:], local.dtype)
        pad[: local.shape[0]] = local
        stacked = np.asarray(mhu.process_allgather(pad))  # (count, m, ...)
        return np.concatenate(
            [stacked[i, : int(ns[i])] for i in range(self.count)], axis=0)


def write_at(path: str, offset: int, data: bytes,
             total_size: int | None = None) -> None:
    """Positional write into a (shared-FS) file, creating/extending it.

    total_size (the final file size, known identically on every host from
    the gathered sizes) truncates stale bytes from a previous run; it never
    cuts live data, so no cross-host ordering is required."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        if total_size is not None:
            os.ftruncate(fd, total_size)
        if data:
            os.pwrite(fd, data, offset)
    finally:
        os.close(fd)


def shaf_frame(payload: bytes) -> bytes:
    return f"@{len(payload)}@".encode("ascii") + payload


def shaf_offsets(payload_sizes: np.ndarray) -> tuple[np.ndarray, int]:
    """Byte offset of every block's frame within the .shaf file, + total.

    Header is '@<n_blocks>'; each frame '@<size>@<payload>' (c.c:351,256-258).
    Every host computes this identically from the all-gathered sizes."""
    n = len(payload_sizes)
    header = len(f"@{n}")
    frame_sizes = np.array(
        [len(f"@{int(s)}@") + int(s) for s in payload_sizes], np.int64)
    offs = header + np.concatenate(([0], np.cumsum(frame_sizes)[:-1]))
    return offs, int(header + frame_sizes.sum())


def _splice_spool(spool, dst_path: str, dst_off: int, total: int) -> None:
    """Copy a local spool file into the shared output at dst_off in bounded
    chunks (creates/extends the destination to `total` bytes)."""
    spool.seek(0)
    fd = os.open(dst_path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        os.ftruncate(fd, total)
        while True:
            chunk = spool.read(64 << 20)
            if not chunk:
                break
            os.pwrite(fd, chunk, dst_off)
            dst_off += len(chunk)
    finally:
        os.close(fd)


def _host_batches(rng: BlockRange, block_size: int):
    """This host's block range cut into device-batch-sized index ranges."""
    from .device import MAX_BATCH_ELEMS, _bucket
    p = _bucket(block_size)
    bsz = max(1, MAX_BATCH_ELEMS // p)
    return [(lo, min(lo + bsz, rng.hi)) for lo in range(rng.lo, rng.hi, bsz)]


def compress_multihost(path: str, block_size: int, backend,
                       comm: Comm | None = None,
                       force_rle: bool = False,
                       force_freq: bool = False) -> str:
    """Modules F+T+C across hosts; byte-identical output files to the
    single-host pipeline (differential-tested in tests/test_multihost.py).

    Bounded memory: each host streams its block range one device batch at a
    time (the reference keeps one block resident, f.c:231-356; the 100 GiB /
    16-host config cannot slurp ~6 GiB of input per host). Because a host's
    write offset into the shared .rle/.shaf depends on every EARLIER host's
    sizes — known only after its own pass completes — per-host bytes go to
    a local spool file and are spliced at the gathered offset afterwards.

    Every host executes this same function; writes are offset-disjoint, so
    ordering between hosts is irrelevant (no barrier needed before the data
    writes; callers that must observe a complete file barrier afterwards
    via jax.experimental.multihost_utils.sync_global_devices)."""
    import tempfile

    comm = comm or Comm()
    pi, pc = comm.index, comm.count

    if not os.path.isfile(path):
        raise FileInaccessibleError(path)
    geo = geometry.geometry_for_file(path, block_size)
    if geo.total < geometry.MIN_FILE_SIZE:
        raise FileTooSmallError(path)
    sizes = geo.sizes()
    rng = partition_blocks(geo.n_blocks, pc, pi)
    batches = _host_batches(rng, block_size)
    spool_dir = os.path.dirname(path) or "."

    # --- pass F: stream batches; spool RLE bytes, keep KB-scale metadata ---
    my_rle_sizes = np.zeros(rng.n, np.int64)
    my_rle_hists = np.zeros((rng.n, 256), np.int64)
    rle_spool = tempfile.TemporaryFile(dir=spool_dir)
    with open(path, "rb") as fp:
        for lo, hi in batches:
            blocks = _read_blocks_at(fp, sizes, lo, hi)
            h = backend.fused_encode(blocks)
            my_rle_sizes[lo - rng.lo: hi - rng.lo] = \
                backend.fused_rle_sizes(h)
            my_rle_hists[lo - rng.lo: hi - rng.lo] = \
                backend.fused_rle_hists(h)
            rle_spool.write(backend.fused_rle_bytes(h).tobytes())
            del h  # free the batch's device arrays (bounded HBM)

    rle_sizes = comm.allgather(my_rle_sizes)
    # Gate from global block 0 (f.c:250-257) — every host computes the same
    # decision from the gathered sizes.
    ratio = (sizes[0] - int(rle_sizes[0])) / sizes[0]
    compress_rle = force_rle or ratio >= 0.05

    path_rle = formats.add_ext(path, formats.RLE_EXT)
    if compress_rle:
        rle_offs = np.concatenate(([0], np.cumsum(rle_sizes)))
        _splice_spool(rle_spool, path_rle, int(rle_offs[rng.lo]),
                      int(rle_offs[-1]))
        freqs = comm.allgather(my_rle_hists)
        stream_sizes = rle_sizes
        mode = "R"
        if pi == 0:
            with open(formats.add_ext(path_rle, formats.FREQ_EXT),
                      "wb") as fp:
                formats.write_freq_arrays(fp, "R", rle_sizes, freqs)
    rle_spool.close()
    if force_freq or not compress_rle:
        # Raw histograms: second streaming pass (histogram-only; happens for
        # incompressible inputs or -c f, mirroring f.c:278-334).
        my_nfreqs = np.zeros((rng.n, 256), np.int64)
        with open(path, "rb") as fp:
            for lo, hi in batches:
                blocks = _read_blocks_at(fp, sizes, lo, hi)
                my_nfreqs[lo - rng.lo: hi - rng.lo] = \
                    np.stack(backend.histogram(blocks))
        nfreqs = comm.allgather(my_nfreqs)
        if pi == 0:
            with open(formats.add_ext(path, formats.FREQ_EXT), "wb") as fp:
                formats.write_freq_arrays(fp, "N", sizes, nfreqs)
        if not compress_rle:
            mode, stream_sizes, freqs = "N", np.asarray(sizes), nfreqs

    # Module T: identical tables on every host (deterministic construction
    # from the gathered histograms) — no broadcast needed.
    tables = codes_mod.build_code_tables(freqs)
    data_path = path_rle if compress_rle else path
    if pi == 0:
        with open(formats.add_ext(data_path, formats.CODES_EXT), "wb") as fp:
            formats.write_cod_tables(fp, mode,
                                     [int(s) for s in stream_sizes], tables)

    # --- pass C: stream the data stream batch-wise, pack, spool frames ----
    stream_np = np.asarray(stream_sizes, np.int64)
    my_psizes = np.zeros(rng.n, np.int64)
    shaf_spool = tempfile.TemporaryFile(dir=spool_dir)
    with open(data_path, "rb") as fp:
        for lo, hi in batches:
            blocks = _read_blocks_at(fp, stream_np, lo, hi)
            sub = codes_mod.CodeTables(
                tables.lens[lo:hi], tables.vals[lo:hi],
                {i - lo: v for i, v in tables.overflow.items()
                 if lo <= i < hi})
            payloads = backend.pack(blocks, sub)
            for j, pay in enumerate(payloads):
                my_psizes[lo - rng.lo + j] = len(pay)
                shaf_spool.write(shaf_frame(pay))

    psizes = comm.allgather(my_psizes)
    offs, total = shaf_offsets(psizes)
    path_shafa = formats.add_ext(data_path, formats.SHAFA_EXT)
    if pi == 0:
        write_at(path_shafa, 0, f"@{geo.n_blocks}".encode("ascii"),
                 total_size=total)
    if rng.n:
        _splice_spool(shaf_spool, path_shafa, int(offs[rng.lo]), total)
    shaf_spool.close()
    return path_shafa


def _read_blocks_at(fp, sizes, lo: int, hi: int) -> list[np.ndarray]:
    """Blocks [lo, hi) of an open stream whose block sizes are `sizes`
    (one contiguous pread)."""
    start = int(np.sum(np.asarray(sizes[:lo], np.int64)))
    fp.seek(start)
    buf = fp.read(int(np.sum(np.asarray(sizes[lo:hi], np.int64))))
    out, pos = [], 0
    for s in sizes[lo:hi]:
        out.append(np.frombuffer(buf, np.uint8, count=int(s), offset=pos))
        pos += int(s)
    return out


#: chunk size for the buffered .shaf header scan
_SCAN_CHUNK = 1 << 20


def scan_shaf_offsets(path: str) -> tuple[np.ndarray, np.ndarray, int]:
    """(payload_offsets, payload_sizes, n_blocks) by reading only the
    ASCII frame headers (~20 bytes per block) — the whole-archive read this
    replaces cost H * archive_size aggregate across hosts.

    Buffered: headers are matched inside 1 MiB chunks, so a small-block
    archive (64 KiB frames) scans ~16 frames per syscall instead of one
    seek+read pair per frame (1.6M syscalls for 100 GiB at 64 KiB). Frames
    larger than a chunk refill with a header-sized read."""
    from .errors import FileUnrecognizableError
    import re
    hdr = re.compile(rb"@(\d+)@")
    with open(path, "rb") as fp:
        buf = fp.read(_SCAN_CHUNK)
        m = re.match(rb"@(\d+)", buf)
        if not m:
            raise FileUnrecognizableError(".shaf header")
        n_blocks = int(m.group(1))
        base = 0            # file offset of buf[0]
        pos = m.end()       # absolute offset of the next frame header
        offs = np.zeros(n_blocks, np.int64)
        sizes = np.zeros(n_blocks, np.int64)
        for i in range(n_blocks):
            if pos - base + 32 > len(buf):
                # refill: big chunk while frames look small, header-sized
                # read once a frame exceeded the chunk (avoids reading MBs
                # of payload per 64 MiB frame)
                want = _SCAN_CHUNK if i == 0 or sizes[i - 1] < _SCAN_CHUNK \
                    else 32
                fp.seek(pos)
                buf = fp.read(want)
                base = pos
            m = hdr.match(buf, pos - base)
            if not m:
                raise FileUnrecognizableError(".shaf frame header")
            sizes[i] = int(m.group(1))
            offs[i] = base + m.end()
            pos = int(offs[i] + sizes[i])
    return offs, sizes, n_blocks


def decompress_multihost(path: str, backend,
                         comm: Comm | None = None) -> str:
    """Module D across hosts: each host header-scans the archive (KB-scale
    reads), preads ONLY its contiguous payload range, decodes it batch-wise
    into a local spool file (bounded RSS), and splices the spool into the
    shared output at the offset implied by the gathered decoded sizes."""
    import tempfile

    comm = comm or Comm()
    pi, pc = comm.index, comm.count

    path_tmp = formats.rm_ext(path)  # strip .shaf
    rle = formats.check_ext(path_tmp, formats.RLE_EXT)
    path_wrt = formats.rm_ext(path_tmp) if rle else path_tmp
    with open(formats.add_ext(path_tmp, formats.CODES_EXT), "rb") as fp:
        mode, block_sizes, tables = formats.parse_cod_tables(fp.read())
    frame_offs, frame_sizes, n_blocks = scan_shaf_offsets(path)
    if n_blocks != len(block_sizes):
        from .errors import FileUnrecognizableError
        raise FileUnrecognizableError("block count mismatch .shaf vs .cod")

    rng = partition_blocks(n_blocks, pc, pi)
    expand = rle and mode == "R"
    # batch granularity like the fused decoder's
    from .device import MAX_BATCH_ELEMS, _bucket
    p = _bucket(max(block_sizes) if block_sizes else 1)
    bsz = max(1, MAX_BATCH_ELEMS // (p * 8))

    my_sizes = np.zeros(rng.n, np.int64)
    spool = tempfile.TemporaryFile(dir=os.path.dirname(path) or ".")
    with open(path, "rb") as fp:
        for lo in range(rng.lo, rng.hi, bsz):
            hi = min(lo + bsz, rng.hi)
            fp.seek(frame_offs[lo])
            buf = fp.read(int(frame_offs[hi - 1] + frame_sizes[hi - 1]
                              - frame_offs[lo]))
            base = frame_offs[lo]
            payloads = [
                buf[int(frame_offs[i] - base):
                    int(frame_offs[i] - base + frame_sizes[i])]
                for i in range(lo, hi)]
            sub = codes_mod.CodeTables(
                tables.lens[lo:hi], tables.vals[lo:hi],
                {i - lo: v for i, v in tables.overflow.items()
                 if lo <= i < hi})
            out_blocks = backend.fused_decode(
                payloads, sub, block_sizes[lo:hi], expand=expand)
            for j, b in enumerate(out_blocks):
                my_sizes[lo - rng.lo + j] = b.size
                spool.write(b.tobytes())

    out_sizes = comm.allgather(my_sizes)
    offs = np.concatenate(([0], np.cumsum(out_sizes)))
    # splice the spool into the shared output in bounded chunks
    total = int(offs[-1])
    dst_off = int(offs[rng.lo])
    spool.seek(0)
    fd = os.open(path_wrt, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        os.ftruncate(fd, total)
        while True:
            chunk = spool.read(64 << 20)
            if not chunk:
                break
            os.pwrite(fd, chunk, dst_off)
            dst_off += len(chunk)
    finally:
        os.close(fd)
        spool.close()
    return path_wrt
