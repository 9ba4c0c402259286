"""Port parity: the host-side data path of ``pacingpseudo_torch``
(``tools/scribbles.py``, ``data/synthetic.py``, ``data/splits.py``,
``data/npz_dataset.py``) against the JAX package's numpy modules.

Both sides are numpy code run from the same seed, so everything is held
**exactly**: phantoms, scribbles, the files a synthetic pool writes, its
split lists and marker, a padded slice, and the loader's batch order under
``set_epoch``.  The JAX package's loader runs with ``native=False``, its
numpy path: the port has no C++ loader.
"""
import os

import numpy as np
import pytest
import torch

from pacingpseudo_tpu.data import npz_dataset as jax_npz
from pacingpseudo_tpu.data import splits as jax_splits
from pacingpseudo_tpu.data import synthetic as jax_synthetic
from pacingpseudo_tpu.tools import scribbles as jax_scribbles
from pacingpseudo_torch.data import npz_dataset, splits, synthetic
from pacingpseudo_torch.tools import scribbles

POOL = dict(dataset="chaos", num_slices=20, size=(40, 48), num_classes=5,
            ignored_index=5, seed=3, size_jitter=6)


@pytest.mark.parametrize("difficulty", ["easy", "hard", "jagged"])
def test_make_phantom(difficulty):
    a = jax_synthetic.make_phantom(np.random.RandomState(1), (48, 56), 5, difficulty)
    b = synthetic.make_phantom(np.random.RandomState(1), (48, 56), 5, difficulty)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("style", ["skeleton", "dilated"])
def test_generate_scribble_and_shortening(style):
    _, lab = synthetic.make_phantom(np.random.RandomState(2), (64, 64), 5)
    want = jax_scribbles.generate_scribble(lab, 5, 5, style=style)
    got = scribbles.generate_scribble(lab, 5, 5, style=style)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= set(range(6)) and (got != 5).any()
    np.testing.assert_array_equal(
        synthetic.shorten_scribbles(got, 5, 5, 0.5),
        jax_synthetic.shorten_scribbles(want, 5, 5, 0.5))
    np.testing.assert_array_equal(
        scribbles.detect_endpoints(got == 1), jax_scribbles.detect_endpoints(want == 1))


def test_background_only_scribble_becomes_a_line():
    lab = np.zeros((48, 48), np.int32)
    want = jax_scribbles.generate_scribble(lab, 5, 5)
    got = scribbles.generate_scribble(lab, 5, 5)
    np.testing.assert_array_equal(got, want)
    assert (got == 0).sum() > 1


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """The same synthetic pool written by both packages."""
    roots = {}
    for name, module in (("jax", jax_synthetic), ("port", synthetic)):
        root = str(tmp_path_factory.mktemp(name))
        roots[name] = (root, module.write_synthetic_dataset(root, **POOL))
    return roots


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_write_synthetic_dataset_files_splits_and_marker(pools):
    (jroot, jrel), (proot, prel) = pools["jax"], pools["port"]
    assert prel == jrel and len(prel) == POOL["num_slices"]
    assert _tree(proot) == _tree(jroot)
    for rel in _tree(proot):
        a, b = os.path.join(jroot, rel), os.path.join(proot, rel)
        if rel.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files) == ["img", "lab", "scb", "uid"]
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=f"{rel}:{k}")
        else:                                   # split lists and the marker
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), rel
    # a second call keeps the pool (the marker matches) and rewrites the lists
    before = os.path.getmtime(os.path.join(proot, "chaos", prel[0]))
    assert synthetic.write_synthetic_dataset(proot, **POOL) == prel
    assert os.path.getmtime(os.path.join(proot, "chaos", prel[0])) == before


@pytest.mark.parametrize("fold", [0, 3])
def test_read_fold_split(pools, fold):
    (jroot, _), (proot, _) = pools["jax"], pools["port"]
    jt, jv = jax_splits.read_fold_split(jroot, "chaos", fold)
    pt, pv = splits.read_fold_split(proot, "chaos", fold)
    rel = lambda files, root: [os.path.relpath(f, root) for f in files]  # noqa: E731
    assert rel(pt, proot) == rel(jt, jroot) and rel(pv, proot) == rel(jv, jroot)
    assert pt and pv and not set(pt) & set(pv)
    assert splits.read_test_split(proot, "chaos", fold, modality="t1") == pv
    assert splits.read_fold_split(proot, "chaost1", fold) == (pt, pv)


def test_slice_dataset_load(pools):
    (jroot, _), (proot, _) = pools["jax"], pools["port"]
    jds = jax_npz.SliceDataset(jax_splits.read_fold_split(jroot, "chaos", 1)[0], 5, 5)
    pds = npz_dataset.SliceDataset(splits.read_fold_split(proot, "chaos", 1)[0], 5, 5)
    assert len(pds) == len(jds) and pds.canvas_size == jds.canvas_size == 64
    for i in (0, len(pds) - 1):
        a, b = jds.load(i), pds.load(i)
        assert a["uid"] == b["uid"]
        for k in npz_dataset.RAW_KEYS:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        h, w = b["size"]
        assert (b["label"][h:] == 5).all() and (b["image"][:, w:] == 0).all()
    with pytest.raises(ValueError, match="exceeds canvas"):
        npz_dataset.SliceDataset(pds.file_ls, 5, 5, canvas_size=32).load(0)
    with pytest.raises(ValueError, match="Empty"):
        npz_dataset.SliceDataset([], 5, 5)


@pytest.mark.parametrize("threads", [0, 3], ids=["inline", "threads"])
def test_batch_loader_order_under_set_epoch(pools, threads):
    (jroot, _), (proot, _) = pools["jax"], pools["port"]
    jds = jax_npz.SliceDataset(jax_splits.read_fold_split(jroot, "chaos", 0)[0], 5, 5)
    pds = npz_dataset.SliceDataset(splits.read_fold_split(proot, "chaos", 0)[0], 5, 5)
    kw = dict(batch_size=3, shuffle=True, drop_last=True, seed=4, num_threads=threads)
    jl = jax_npz.BatchLoader(jds, native=False, **kw)
    pl = npz_dataset.BatchLoader(pds, **kw)
    assert len(pl) == len(jl) == len(pds) // 3
    orders = []
    for epoch in (0, 1, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        got, want = list(pl), list(jl)
        assert len(got) == len(want) == len(pl)
        for a, b in zip(want, got):
            assert a["uid"] == b["uid"]
            for k in npz_dataset.RAW_KEYS:
                np.testing.assert_array_equal(a[k], b[k])
        orders.append([u for b in got for u in b["uid"]])
    assert orders[1] == orders[2] and orders[0] != orders[1]
    # keep-last, ordered validation loader
    val = npz_dataset.BatchLoader(pds, batch_size=5, num_threads=threads)
    sizes = [len(b["uid"]) for b in val]
    assert sum(sizes) == len(pds) and len(sizes) == len(val)
    assert [u for b in val for u in b["uid"]] == [
        os.path.splitext(os.path.basename(f))[0] for f in pds.file_ls]


def test_batch_loader_hands_on_a_load_error_and_stops_early(pools):
    proot, _ = pools["port"]
    files = splits.read_fold_split(proot, "chaos", 0)[0]
    broken = npz_dataset.SliceDataset(files[:4] + ["/nonexistent/slice.npz"], 5, 5,
                                      canvas_size=64)
    with pytest.raises(FileNotFoundError):
        list(npz_dataset.BatchLoader(broken, batch_size=2, num_threads=2))
    loader = npz_dataset.BatchLoader(
        npz_dataset.SliceDataset(files, 5, 5), batch_size=1, num_threads=2,
        prefetch=1)
    first = next(iter(loader))                  # leaving early does not hang
    assert len(first["uid"]) == 1


def test_raw_batch_to_device(pools):
    proot, _ = pools["port"]
    ds = npz_dataset.SliceDataset(splits.read_fold_split(proot, "chaos", 2)[0], 5, 5)
    batch = next(iter(npz_dataset.BatchLoader(ds, batch_size=4, num_threads=0)))
    raw = npz_dataset.raw_batch_to_device(batch, "cpu")
    assert sorted(raw) == sorted(npz_dataset.RAW_KEYS)
    for k in ("image", "label", "scribble"):
        assert raw[k].dtype == torch.float32 and tuple(raw[k].shape) == (4, 64, 64)
        np.testing.assert_array_equal(raw[k].numpy(), batch[k])
    assert raw["size"].dtype == torch.int32 and tuple(raw["size"].shape) == (4, 2)
