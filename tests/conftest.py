"""Test env: force JAX onto a virtual 8-device CPU platform so sharding tests
run without accelerator hardware (SURVEY.md §4 'Distributed level'). Must be
set before jax imports anywhere in the test process:

    JAX_PLATFORMS=cpu python -m pytest tests/ -q -m 'not slow'
"""

import os
import shutil
import subprocess
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-process / large-input tests")

REF_SRC = "/root/reference/src"
REF_BIN = "/tmp/refbin/shafa"


def _ensure_ref_binary() -> str | None:
    """Compile the C reference once (per README.md:25) for golden tests."""
    if os.path.exists(REF_BIN):
        return REF_BIN
    if not os.path.isdir(REF_SRC) or shutil.which("gcc") is None:
        return None
    os.makedirs(os.path.dirname(REF_BIN), exist_ok=True)
    srcs = subprocess.run(
        ["find", REF_SRC, "-name", "*.c"], capture_output=True, text=True,
        check=True).stdout.split()
    r = subprocess.run(
        ["gcc", "-o", REF_BIN, *srcs, "-O3", "-Wno-format", "-pthread"],
        capture_output=True)
    return REF_BIN if r.returncode == 0 else None


@pytest.fixture(scope="session")
def ref_binary():
    path = _ensure_ref_binary()
    if path is None:
        pytest.skip("C reference binary unavailable")
    return path
