"""True multi-process multihost test: 2 jax.distributed CPU processes.

Each process runs the real CLI (`python -m shafa_tpu`) with the standard
coordinator env; the CLI joins the runtime (cli.main -> multihost.
init_from_env) and routes the full chain through compress_multihost /
decompress_multihost. The resulting sidecars must be byte-identical to a
single-host run — the SURVEY §4 'Distributed level' invariant the
thread-simulated tests (test_multihost.py) cannot cover: process isolation,
env init, and jax's process_allgather over the distributed runtime.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from corpus import mixed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args, pid, port, nprocs):
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "NUM_PROCESSES": str(nprocs),
        "PROCESS_ID": str(pid),
        # one CPU device per process: the minimal real multi-host topology
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
    })
    return subprocess.Popen(
        [sys.executable, "-m", "shafa_tpu", *args],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _run_procs(args, nprocs=2, timeout=420):
    port = _free_port()
    procs = [_spawn(args, pid, port, nprocs) for pid in range(nprocs)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"multihost process failed: {err[-2000:]}"
    return outs


@pytest.mark.slow
def test_two_process_compress_matches_single_host(tmp_path):
    data = mixed(400_000, seed=21)
    pa = str(tmp_path / "mh.bin")
    pb = str(tmp_path / "sh.bin")
    for p in (pa, pb):
        with open(p, "wb") as fp:
            fp.write(data)

    _run_procs([pa, "-b", "K"])

    # single-host reference run (numpy backend: deterministic, no jax init)
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu"})
    r = subprocess.run([sys.executable, "-m", "shafa_tpu", pb, "-b", "K",
                        "--backend", "numpy"],
                       env=env, cwd=REPO, capture_output=True, timeout=420)
    assert r.returncode == 0, r.stderr

    exts = [".rle", ".rle.freq", ".rle.cod", ".rle.shaf"]
    if not os.path.exists(pa + ".rle"):
        exts = [".freq", ".cod", ".shaf"]
    for ext in exts:
        with open(pa + ext, "rb") as fa, open(pb + ext, "rb") as fb:
            assert fa.read() == fb.read(), f"{ext}: multihost != single-host"


@pytest.mark.slow
def test_two_process_compress_streams_batches(tmp_path):
    # Bounded-memory multihost compress: shrink the device batch cap so each
    # host's 5-block range needs 5 separate batches (spool + splice path),
    # and require byte-identical outputs to a single-host run.
    data = mixed(600_000, seed=23)
    pa = str(tmp_path / "mhs.bin")
    pb = str(tmp_path / "shs.bin")
    for p in (pa, pb):
        with open(p, "wb") as fp:
            fp.write(data)

    os.environ["SHAFA_MAX_BATCH_ELEMS"] = "65536"  # bsz=1 at -b K
    try:
        _run_procs([pa, "-b", "K"])
    finally:
        del os.environ["SHAFA_MAX_BATCH_ELEMS"]

    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu"})
    r = subprocess.run([sys.executable, "-m", "shafa_tpu", pb, "-b", "K",
                        "--backend", "numpy"],
                       env=env, cwd=REPO, capture_output=True, timeout=420)
    assert r.returncode == 0, r.stderr

    exts = [".rle", ".rle.freq", ".rle.cod", ".rle.shaf"]
    if not os.path.exists(pa + ".rle"):
        exts = [".freq", ".cod", ".shaf"]
    for ext in exts:
        with open(pa + ext, "rb") as fa, open(pb + ext, "rb") as fb:
            assert fa.read() == fb.read(), f"{ext}: multihost != single-host"


@pytest.mark.slow
def test_two_process_decompress_roundtrip(tmp_path):
    data = mixed(300_000, seed=22)
    p = str(tmp_path / "rt.bin")
    with open(p, "wb") as fp:
        fp.write(data)
    _run_procs([p, "-b", "K"])
    shaf = next(str(tmp_path / f) for f in os.listdir(tmp_path)
                if f.endswith(".shaf"))
    os.rename(p, p + ".orig")
    _run_procs([shaf])
    with open(p, "rb") as fp:
        assert fp.read() == data
