"""Port parity: the C++ npz loader of ``pacingpseudo_torch/data/native``
against the JAX package's C++ loader and its numpy ``SliceDataset.load``
path, byte for byte.

The cases of ``tests/test_native_loader.py`` as parametrised tests, plus:
every dtype the source casts (f4/f8/i1/u1/i2/u2/i4/i8), stored and
deflated members, slices smaller than the canvas, files that are cut,
mutated or miss a member (each raises naming the file), ``BatchLoader``
on both routes (equal batches in the same shuffle order, and ``route``),
and the build against the declared zlib ABI that the source uses where a
machine has no ``zlib.h``.  Runs on the CPU: it needs ``g++`` and zlib.
"""
import glob
import logging
from pathlib import Path

import numpy as np
import pytest

from pacingpseudo_tpu.data import SliceDataset as JaxSliceDataset
from pacingpseudo_tpu.data import native as jax_native
from pacingpseudo_torch.data import npz_dataset
from pacingpseudo_torch.data.native import loader as native
from pacingpseudo_torch.data.npz_dataset import BatchLoader, SliceDataset
from pacingpseudo_torch.data.synthetic import write_synthetic_dataset

KEYS = ("image", "label", "scribble", "size")
DTYPES = ("<f4", "<f8", "|i1", "|u1", "<i2", "<u2", "<i4", "<i8")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nat"))
    write_synthetic_dataset(root, "acdc", num_slices=10, size=(48, 40), num_classes=3,
                            ignored_index=3, seed=3)
    return sorted(glob.glob(root + "/acdc/slices/*.npz"))


def _assert_bytes_equal(got, want):
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _numpy_batch(paths, canvas, ignored=3):
    """JAX's numpy route: ``SliceDataset.load`` of each file, stacked."""
    ds = JaxSliceDataset(paths, 3, ignored, canvas_size=canvas)
    rows = [ds.load(i) for i in range(len(paths))]
    return {k: np.stack([r[k] for r in rows]) for k in KEYS}


def _write(path, dtype, shape, seed, compressed=False):
    rs = np.random.RandomState(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        img = (rs.randn(*shape) * 300).astype(dt)
    else:
        info = np.iinfo(dt)
        img = rs.randint(max(info.min, -(2 ** 40)), min(info.max, 2 ** 40),
                         shape, dtype=np.int64).astype(dt)
    lab = rs.randint(0, 3, shape).astype(dt)
    scb = rs.randint(0, 4, shape).astype(dt)
    save = np.savez_compressed if compressed else np.savez
    save(path, uid="x", img=img, lab=lab, scb=scb)
    return str(path)


def test_port_matches_jax_native_and_numpy(files):
    canvas = SliceDataset(files, 3, 3).canvas_size
    got = native.load_batch_native(files, canvas, 3.0)
    _assert_bytes_equal(got, jax_native.load_batch_native(files, canvas, 3.0))
    _assert_bytes_equal(got, _numpy_batch(files, canvas))
    assert got["image"].dtype == np.float32 and got["size"].dtype == np.int32


@pytest.mark.parametrize("compressed", [False, True], ids=["stored", "deflated"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dtypes_and_compression_match(tmp_path, dtype, compressed):
    """Every member dtype the source casts, stored (np.savez) and deflated
    (np.savez_compressed), on a slice smaller than the canvas in both
    directions (the padding: image 0, label and scribble ``ignored``)."""
    paths = [_write(tmp_path / f"s{i}.npz", dtype, shape, seed=i, compressed=compressed)
             for i, shape in enumerate([(10, 12), (32, 7), (5, 32)])]
    got = native.load_batch_native(paths, 32, 3.0)
    _assert_bytes_equal(got, jax_native.load_batch_native(paths, 32, 3.0))
    _assert_bytes_equal(got, _numpy_batch(paths, 32))
    assert np.all(got["label"][0, 10:, :] == 3.0) and np.all(got["image"][0, :, 12:] == 0.0)
    assert got["size"].tolist() == [[10, 12], [32, 7], [5, 32]]


def test_compressed_equals_stored(files, tmp_path):
    p = str(tmp_path / "comp.npz")
    with np.load(files[0]) as src:
        np.savez_compressed(p, uid=src["uid"], img=src["img"], lab=src["lab"], scb=src["scb"])
    _assert_bytes_equal(native.load_batch_native([p], 64, 3.0),
                        native.load_batch_native([files[0]], 64, 3.0))


def _broken(tmp_path, files, case):
    raw = Path(files[0]).read_bytes()
    p = str(tmp_path / f"{case}.npz")
    if case.startswith("trunc"):
        data = raw[: int(len(raw) * int(case[5:]) / 100)]
    elif case == "mutated":
        mut = bytearray(raw)
        for off in range(len(mut) - 40, len(mut) - 20):
            mut[off] ^= 0xFF
        data = bytes(mut)
    elif case == "junk":
        data = b"not a zip at all"
    else:                                    # a zip without the scb member
        with np.load(files[0]) as src:
            np.savez(p, uid=src["uid"], img=src["img"], lab=src["lab"])
        return p
    with open(p, "wb") as f:
        f.write(data)
    return p


@pytest.mark.parametrize("case", ["trunc30", "trunc60", "trunc90", "mutated", "junk",
                                  "missing_member"])
def test_broken_files_raise_with_the_name(files, tmp_path, case):
    """A cut, mutated or incomplete file raises, naming the file, on both
    loaders, and the batch's good files do not hide it."""
    p = _broken(tmp_path, files, case)
    for load in (native.load_batch_native, jax_native.load_batch_native):
        with pytest.raises(RuntimeError, match=case):
            load([files[0], p, files[1]], 64, 3.0)


def test_native_batch_loader_iterates(files):
    loader = native.NativeBatchLoader(files, canvas=64, ignored_index=3.0,
                                      batch_size=4, shuffle=True, seed=0)
    want = jax_native.NativeBatchLoader(files, canvas=64, ignored_index=3.0,
                                        batch_size=4, shuffle=True, seed=0)
    total = 0
    for got, ref in zip(loader, want, strict=True):
        _assert_bytes_equal(got, ref)
        assert got["uid"] == ref["uid"]
        total += got["image"].shape[0]
    assert total == 10 and len(loader) == 3


@pytest.mark.parametrize("num_threads", [0, 3])
def test_batch_loader_routes_give_equal_batches(files, num_threads):
    """``BatchLoader`` on the native and the numpy route: the same batches,
    uids included, in the same shuffle order, and ``route`` names each."""
    ds = SliceDataset(files, 3, 3)
    loaders = [BatchLoader(ds, 4, shuffle=True, seed=7, num_threads=num_threads,
                           native=native_) for native_ in (True, False)]
    assert [ld.route for ld in loaders] == ["native", "numpy"]
    for ld in loaders:
        ld.set_epoch(2)
    for got, want in zip(*loaders, strict=True):
        _assert_bytes_equal(got, want)
        assert got["uid"] == want["uid"]


def test_staged_pool_equal_on_both_routes(files, monkeypatch):
    """A resident pool staged through the native route is bit-equal to one
    staged through numpy (``shrink_raw`` rounds after the load either way)."""
    from pacingpseudo_torch.data.resident import stage_train_pool
    ds = SliceDataset(files, 3, 3)
    pools = {}
    for route in (True, False):
        monkeypatch.setattr(npz_dataset, "_native_route", lambda r=route: r)
        pools[route] = stage_train_pool(ds, "cpu")
    for k in KEYS:
        assert pools[True][k].dtype == pools[False][k].dtype
        assert pools[True][k].numpy().tobytes() == pools[False][k].numpy().tobytes(), k


def test_numpy_route_when_the_build_fails(files, monkeypatch, caplog):
    """A library that cannot be built leaves the numpy route, logged once
    with the compiler's message."""
    npz_dataset._native_route.cache_clear()
    monkeypatch.setattr(native, "_library", lambda: (None, "g++: error: no zlib"))
    try:
        with caplog.at_level(logging.WARNING):
            a = BatchLoader(SliceDataset(files, 3, 3), 4)
            b = BatchLoader(SliceDataset(files, 3, 3), 4)
        assert a.route == b.route == "numpy"
        lines = [r.getMessage() for r in caplog.records if "native npz loader" in r.getMessage()]
        assert len(lines) == 1 and "no zlib" in lines[0] and "numpy route" in lines[0]
    finally:
        npz_dataset._native_route.cache_clear()


def test_declared_zlib_abi_matches(files, tmp_path):
    """The source's own zlib declarations (the branch a machine without
    ``zlib.h`` compiles) load deflated members as zlib's header does."""
    lib = native.open_library(native.build(("-DPPT_DECLARE_ZLIB",)))
    p = str(tmp_path / "comp.npz")
    with np.load(files[0]) as src:
        np.savez_compressed(p, uid=src["uid"], img=src["img"], lab=src["lab"], scb=src["scb"])
    _assert_bytes_equal(native.load_batch_native([p, files[1]], 64, 3.0, lib=lib),
                        native.load_batch_native([p, files[1]], 64, 3.0))


def test_library_is_keyed_on_its_source():
    """The build's file name carries a digest of the source and flags, under
    the git-ignored ``build/``, never in the package."""
    path = native.library_path()
    assert path.parent.name == "build" and path.name.startswith("libnpz_loader-")
    assert path != native.library_path(("-DPPT_DECLARE_ZLIB",))
    assert native.SOURCE.parent not in path.parents


def test_missing_file_raises_file_not_found(files, tmp_path):
    """A path that does not exist raises ``FileNotFoundError`` on the native
    route, as ``np.load`` does on the numpy route."""
    missing = str(tmp_path / "absent.npz")
    with pytest.raises(FileNotFoundError, match="absent"):
        native.load_batch_native([files[0], missing], 64, 3.0)
