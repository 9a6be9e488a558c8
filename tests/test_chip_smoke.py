"""The parts of chip_smoke.py and of its surroundings that run without a
GPU: the device check, the oracle-qualification check on a .cod, the
compile-cache placement, the one-device-per-process rule of multi-process
start-up, and that no Pallas kernel or platform switch is left."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from shafa_tpu import codes as codes_mod, compile_cache, formats, multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_device_check_fails_without_gpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_fails_alone_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _canonical(max_len: int):
    lens_list = list(range(1, max_len)) + [max_len, max_len]
    code, prev, out = 0, 0, [""] * 256
    for s, ln in enumerate(lens_list):
        code <<= ln - prev
        out[s] = format(code, f"0{ln}b")
        code += 1
        prev = ln
    return out


@pytest.mark.parametrize("case,size,want", [
    ("built", 1 << 20, []),
    ("longest_32", 1 << 20, []),
    ("over_32_bits", 1 << 20, [0]),
    ("incomplete", 1 << 20, [0]),
    ("offset_overflow", 1 << 27, [0]),
])
def test_oracle_blocks(tmp_path, case, size, want):
    if case == "built":
        hist = np.bincount(np.arange(size) % 7, minlength=256)
        strings = codes_mod.build_codes(hist)
    elif case == "longest_32":
        strings = _canonical(32)
    elif case == "over_32_bits":
        strings = _canonical(33)
    elif case == "incomplete":
        strings = ["0", "10"] + [""] * 254  # Kraft sum 3/4
    else:
        strings = _canonical(20)  # 20 bits x 2^27 symbols > 2^31 bits
    cod = str(tmp_path / "x.cod")
    with open(cod, "wb") as fp:
        formats.write_cod_tables(fp, "N", [size],
                                 codes_mod.CodeTables.from_strings([strings]))
    assert chip_smoke.oracle_blocks(cod) == want


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_dir):
    import jax
    before = jax.config.jax_compilation_cache_dir
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache.enable() == os.path.join(REPO, ".jax_cache")
        assert ("jax_compilation_cache_dir",
                os.path.join(REPO, ".jax_cache")) in updates
    else:
        path = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
        assert compile_cache.enable() == path
        assert updates == []  # JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("addr,local_ids", [
    ("127.0.0.1:4321", [1]), ("localhost:4321", [1]),
    ("10.1.2.3:4321", None)])
def test_init_from_env_one_device_per_local_process(monkeypatch, addr,
                                                    local_ids):
    import jax
    calls = []
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    monkeypatch.setenv("COORDINATOR_ADDRESS", addr)
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    multihost.init_from_env()
    assert calls == [dict(coordinator_address=addr, num_processes=2,
                          process_id=1, local_device_ids=local_ids)]


def test_no_pallas_and_no_platform_switch():
    """No module loads Pallas (no kernel is left that needs it), and no code
    picks a path by a platform name other than the GPU/CPU check."""
    sources = [os.path.join(REPO, f) for f in ("bench.py", "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "shafa_tpu")):
        sources += [os.path.join(root, f) for f in files
                    if f.endswith(".py") and f != "__main__.py"]
    modules = [os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
               .removesuffix(".__init__") for p in sources]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.startswith('jax.experimental.pallas')))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"

    switch = re.compile(
        r"""(platform|backend\(\))\s*==\s*["'](?!gpu["']|cpu["'])""")
    for path in sources:
        with open(path) as fp:
            assert not switch.search(fp.read()), path
