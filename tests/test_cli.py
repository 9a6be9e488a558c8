"""CLI behavior: reference-compatible flags + device-side extension flags."""

import json
import os

import numpy as np
import pytest

from shafa_tpu import cli

from corpus import mixed


def _write(tmp, name, data):
    p = str(tmp / name)
    with open(p, "wb") as fp:
        fp.write(data)
    return p


def run_cli(args):
    return cli.main(args)


def test_parse_rejects_reference_syntax_errors():
    assert cli.parse(["-q", "z"]) is None
    assert cli.parse(["-m", "x"]) is None
    assert cli.parse(["-b", "G"]) is None
    assert cli.parse(["-m"]) is None
    assert cli.parse(["a", "b"]) is None  # two positional files
    assert cli.parse(["-mf", "f"]) is None  # key must be 2 chars
    assert cli.parse(["-m", "ff"]) is None  # value must be 1 char


def test_parse_extension_flags():
    opts, f = cli.parse(["x", "--check", "--json", "-", "--profile", "/tmp/p",
                         "--backend", "numpy", "--no-multithread"])
    assert f == "x" and opts.check and opts.json_path == "-"
    assert opts.profile_dir == "/tmp/p" and opts.backend == "numpy"
    assert opts.no_multithread
    assert cli.parse(["x", "--json"]) is None
    assert cli.parse(["x", "--backend", "cuda"]) is None


def test_cli_roundtrip_with_check_and_json(tmp_path, capsys):
    data = mixed(80_000, seed=31)
    path = _write(tmp_path, "f.bin", data)
    jpath = str(tmp_path / "m.json")
    assert run_cli([path, "--backend", "numpy", "--check",
                    "--json", jpath]) == 0
    with open(jpath) as fp:
        m = json.load(fp)
    assert [x["module"] for x in m["modules"]] == ["f", "t", "c"]
    assert m["error"] == 0
    shaf = next(str(tmp_path / f) for f in os.listdir(tmp_path)
                if f.endswith(".shaf"))
    os.rename(path, path + ".orig")
    assert run_cli([shaf, "--backend", "numpy", "--check"]) == 0
    with open(path, "rb") as fp:
        assert fp.read() == data


def test_cli_device_roundtrip_in_process(tmp_path):
    """Compress then decompress through cli.main on the default (jax)
    backend, in this process, as chip_smoke.py drives it."""
    data = mixed(150_000, seed=37)
    path = _write(tmp_path, "f.bin", data)
    assert run_cli([path, "-b", "K"]) == 0
    shaf = next(str(tmp_path / f) for f in os.listdir(tmp_path)
                if f.endswith(".shaf"))
    os.remove(path)
    assert run_cli([shaf]) == 0
    with open(path, "rb") as fp:
        assert fp.read() == data


def test_check_covers_fused_production_path(tmp_path):
    """--check with the jax backend exercises the FUSED chain (the path
    every real compress/decompress takes), not only the per-stage tier."""
    from shafa_tpu import pipeline
    from shafa_tpu.device import JaxBackend
    data = mixed(200_000, seed=35)
    path = _write(tmp_path, "f.bin", data)
    checked = pipeline.CheckedBackend(JaxBackend())
    assert checked.supports_fused  # fused dispatch stays on under --check
    shaf, _ = pipeline.compress_pipeline(path, False, False, 64 << 10,
                                         checked)
    os.rename(path, path + ".orig")
    out, _ = pipeline.module_d_shafa(shaf, rle_decompression=".rle." in shaf,
                                     backend=checked)
    with open(out, "rb") as fp:
        assert fp.read() == data


def test_check_fused_catches_divergence(tmp_path):
    """A backend whose fused tier lies must be caught by --check."""
    from shafa_tpu import pipeline
    from shafa_tpu.device import JaxBackend

    class Lying(JaxBackend):
        def fused_rle_sizes(self, h):
            out = super().fused_rle_sizes(h).copy()
            if out.size:
                out[0] += 1
            return out

    data = mixed(90_000, seed=36)
    path = _write(tmp_path, "f.bin", data)
    with pytest.raises(AssertionError, match="fused_rle_sizes"):
        pipeline.compress_pipeline(path, False, False, 64 << 10,
                                   pipeline.CheckedBackend(Lying()))


def test_no_multithread_identical_archive(tmp_path):
    data = mixed(120_000, seed=32)
    a = _write(tmp_path, "a.bin", data)
    b = _write(tmp_path, "b.bin", data)
    assert run_cli([a]) == 0
    assert run_cli([b, "--no-multithread"]) == 0
    with open(a + ".rle.shaf", "rb") as fa, \
            open(b + ".rle.shaf", "rb") as fb:
        assert fa.read() == fb.read()


def test_error_paths(tmp_path, capsys):
    assert run_cli([]) == 1
    assert "No file input" in capsys.readouterr().err
    assert run_cli(["-q", "z", "x"]) == 1
    assert "Wrong Options' syntax" in capsys.readouterr().err
    assert run_cli([str(tmp_path / "missing.bin"), "-m", "f"]) == 1
    err = capsys.readouterr().err
    assert "Module f" in err and "File can't be accessed" in err
    small = _write(tmp_path, "small.bin", b"x" * 100)
    assert run_cli([small, "-m", "f"]) == 1
    assert "File too small" in capsys.readouterr().err
    data = mixed(80_000, seed=33)
    p = _write(tmp_path, "fc.bin", data)
    assert run_cli([p, "-m", "f", "-m", "c", "--backend", "numpy"]) == 1
    assert "without 't'" in capsys.readouterr().err


def test_atomic_write_no_partial_on_error(tmp_path, monkeypatch):
    """A failing stage must not leave partial outputs (docs/DEVIATIONS.md)."""
    from shafa_tpu import pipeline
    data = mixed(100_000, seed=34)
    path = _write(tmp_path, "x.bin", data)
    backend = pipeline.NumpyBackend()

    def boom(blocks, tables):
        raise pipeline.FileUnrecognizableError("injected")

    monkeypatch.setattr(backend, "pack", boom)
    p, _ = pipeline.module_f(path, False, False, 64 << 10, backend)
    p, _ = pipeline.module_t(p)
    with pytest.raises(pipeline.FileUnrecognizableError):
        pipeline.module_c(p, backend)
    names = set(os.listdir(tmp_path))
    assert not any(n.endswith(".shaf") for n in names)
    assert not any(".shafa_tmp" in n for n in names)
