"""The capture cache of the port's slow system tests.

`cached_capture` keeps a synthetic capture across test sessions under the
temporary directory (`tempfile.gettempdir()`, which follows `$TMPDIR`), in
a folder and under keys of the port's own, so that two checkouts with
their own `TMPDIR` never share a file.  Each file is written under a
temporary name and renamed into place, so that a reader never loads a
half-written capture."""

import os
import pathlib
import tempfile

import numpy as np
import pytest


def cache_dir() -> pathlib.Path:
    d = pathlib.Path(tempfile.gettempdir()) / "gnss_sdr_tpu_torch_testcache"
    d.mkdir(exist_ok=True)
    return d


def cached_capture(key: str, builder) -> np.ndarray:
    """The capture stored under `key`, or `builder()`'s, stored first."""
    path = cache_dir() / f"torch_{key}.npy"
    if path.exists():
        return np.load(path)
    x = builder()
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.stem,
                               suffix=".part")
    try:
        with os.fdopen(fd, "wb") as f:
            np.save(f, x)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return x


def test_cache_follows_tmpdir_and_builds_once(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    calls = []

    def build():
        calls.append(1)
        return np.arange(6, dtype=np.complex64)

    a = cached_capture("k", build)
    b = cached_capture("k", build)
    assert len(calls) == 1
    np.testing.assert_array_equal(a, b)
    assert b.dtype == np.complex64
    files = sorted(p.name for p in (tmp_path / "gnss_sdr_tpu_torch_testcache")
                   .iterdir())
    assert files == ["torch_k.npy"]


def test_failed_write_leaves_no_file(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    def bad_save(f, x):
        f.write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", bad_save)
    with pytest.raises(OSError, match="disk full"):
        cached_capture("k", lambda: np.zeros(4, np.complex64))
    assert list((tmp_path / "gnss_sdr_tpu_torch_testcache").iterdir()) == []
