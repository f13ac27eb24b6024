"""The port's parallel ``.npy`` shard reader (``shadowing_tpu_torch.native``):
the four cases of ``tests/test_native.py``, that nothing falls back to
``numpy.load`` (a failed build, a missing file, a bad header raise), and the
loader built on it against the JAX package's on the same shards. Arrays are
compared exactly: the reader moves bytes."""
import numpy as np
import pytest

import shadowing_tpu as J
import shadowing_tpu_torch as P
from shadowing_tpu_torch import native


def save_shards(path, arrays):
    files = []
    for i, a in enumerate(arrays):
        np.save(path / f"s{i:03d}.npy", a)
        files.append(str(path / f"s{i:03d}.npy"))
    return files


def test_parallel_read_matches_numpy(tmp_path, rng):
    parts = [rng.standard_normal((16, 1, 64)).astype(np.float32)
             for _ in range(6)]
    arrs = native.load_npy_batch(save_shards(tmp_path, parts), n_threads=3)
    assert len(arrs) == 6
    for a, p in zip(arrs, parts):
        assert a.dtype == p.dtype
        np.testing.assert_array_equal(a, p)


def test_r_limit_stops_reading(tmp_path, rng):
    files = save_shards(tmp_path, [rng.standard_normal((10, 4))
                                   for _ in range(5)])
    assert len(native.load_npy_batch(files, R=25)) == 3   # 10 + 10 + 10 >= 25
    assert len(native.load_npy_batch(files, R=30)) == 3
    assert len(native.load_npy_batch(files, R=1000)) == 5


def test_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        native.load_npy_batch([str(tmp_path / "nope.npy")])
    with pytest.raises(OSError):
        native.load_npy_batch([str(tmp_path / "nope.npy")], R=3)


def test_fortran_order_roundtrip(tmp_path, rng):
    a = np.asfortranarray(rng.standard_normal((8, 8)))
    np.save(tmp_path / "f.npy", a)
    (got,) = native.load_npy_batch([str(tmp_path / "f.npy")])
    np.testing.assert_array_equal(got, a)


def test_read_error_inside_the_pool_raises(tmp_path):
    """A path that can be sized but not read (a directory): the C side
    reports the errno, the Python side raises it with the path."""
    with pytest.raises(OSError) as err:
        native.read_files_parallel([str(tmp_path)])
    assert err.value.filename == str(tmp_path)


def test_bad_header_raises_and_nothing_rereads_it(tmp_path, rng, monkeypatch):
    np.save(tmp_path / "a.npy", rng.standard_normal((4, 8)).astype(np.float32))
    (tmp_path / "b.npy").write_bytes(b"not an npy file at all")
    monkeypatch.setattr(np, "load", lambda *a, **kw: pytest.fail(
        "the loader fell back to numpy.load"))
    with pytest.raises(ValueError):
        P.TimeSeriesDataset(tmp_path).load()
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        P.TimeSeriesDataset(tmp_path / "empty")


def test_build_failure_raises(tmp_path, rng, monkeypatch):
    """No compiler, no reader: the loader raises instead of reading the
    shards another way."""
    np.save(tmp_path / "a.npy", rng.standard_normal((4, 8)).astype(np.float32))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_fn", None)
    monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        P.TimeSeriesDataset(tmp_path).load()
    broken = tmp_path / "broken.c"
    broken.write_text("this is not C\n")
    monkeypatch.delenv("CC")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="failed"):
        native.load_npy_batch([str(tmp_path / "a.npy")])
    assert not list((tmp_path / "build").rglob("*.so"))


def test_build_is_cached_by_source(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    first = native.build()
    assert first.exists() and first == native.library_path()
    stamp = first.stat().st_mtime_ns
    assert native.build() == first and first.stat().st_mtime_ns == stamp
    monkeypatch.setattr(native, "CFLAGS", [*native.CFLAGS, "-DOTHER"])
    assert native.library_path() != first


@pytest.mark.parametrize("R", [None, 7, 40])
def test_loader_equals_jax_loader_on_the_same_shards(tmp_path, rng, R):
    """(r, T) and (r, C, T) float64 and float32 shards, through the reader,
    against the JAX package's ``TimeSeriesDataset.load``."""
    two_d = tmp_path / "2d"
    three_d = tmp_path / "3d"
    for d, shape, dtype in ((two_d, (9, 40), np.float64),
                            (three_d, (9, 2, 40), np.float32)):
        d.mkdir()
        save_shards(d, [rng.normal(size=shape).astype(dtype)
                        for _ in range(5)])
        got = P.TimeSeriesDataset(d, R=R).load()
        want = J.TimeSeriesDataset(d, R=R).load()
        assert got.dtype == np.float32 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="fewer than requested"):
        P.TimeSeriesDataset(two_d, R=100).load()
