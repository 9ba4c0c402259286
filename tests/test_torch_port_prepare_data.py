"""Port parity: the data and scribble tooling (``pacingpseudo_torch/tools/
medio.py``, ``tools/prepare_data.py``, ``cli/prepare_data.py``,
``cli/scribble_tools.py``) against ``pacingpseudo_tpu`` on the synthetic raw
inputs that ``tests/test_prepare_data.py`` builds (NIfTI and DICOM files
written byte by byte, intensity-coded PNGs).

Both packages convert the same raw tree into their own output root.  The
outputs must be byte-equal: the same files, every split ``.txt`` equal
byte for byte, and every slice ``.npz`` with the same members holding the
same bytes (a member is one array's ``.npy`` serialisation: header, dtype,
shape and data).  The ``.npz`` containers themselves are zip files that
stamp each member with the time it was written, so they are compared
member by member.  The readers give equal arrays and spacings on the same
files.
"""
import os
import pathlib
import zipfile

import numpy as np
import pytest
from PIL import Image

from pacingpseudo_tpu.cli import prepare_data as jax_cli
from pacingpseudo_tpu.cli import scribble_tools as jax_scribble_cli
from pacingpseudo_tpu.tools import medio as jax_medio
from pacingpseudo_tpu.tools import prepare_data as jax_pd
from pacingpseudo_torch.cli import prepare_data as cli
from pacingpseudo_torch.cli import scribble_tools as scribble_cli
from pacingpseudo_torch.data.synthetic import write_synthetic_dataset
from pacingpseudo_torch.tools import medio
from pacingpseudo_torch.tools import prepare_data as pd
from test_prepare_data import _fake_acdc_tree, make_dicom


def _files(root: pathlib.Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _assert_trees_byte_equal(got: pathlib.Path, want: pathlib.Path):
    names = _files(want)
    assert names and _files(got) == names
    for name in names:
        a, b = got / name, want / name
        if name.endswith(".npz"):
            with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
                assert za.namelist() == zb.namelist(), name
                for member in zb.namelist():
                    assert za.read(member) == zb.read(member), (name, member)
        else:
            assert a.read_bytes() == b.read_bytes(), name


def _chaos_tree(root: pathlib.Path):
    """Two CHAOS T1 patients of three 32x30 DICOMs each (instance order not
    the name order) with coded Ground PNGs, and manual scribble PNGs for one."""
    rs = np.random.RandomState(2)
    for pat in ("1", "2"):
        droot = root / pat / "T1DUAL" / "DICOM_anon" / "InPhase"
        ground = root / pat / "T1DUAL" / "Ground"
        droot.mkdir(parents=True)
        ground.mkdir(parents=True)
        for z, inst in enumerate((2, 3, 1)):
            px = rs.randint(0, 1000, (32, 30)).astype(np.uint16)
            (droot / f"i{z}.dcm").write_bytes(make_dicom(px, spacing=(1.4, 1.8), instance=inst))
            g = np.zeros((32, 30), np.uint8)
            g[10:20, 10:20 + z] = 63
            g[2:6, 2:6] = 252
            g[24:28, 20:26] = 120
            Image.fromarray(g).save(str(ground / f"g{z}.png"))
    sdir = root.parent / "chaos_scribbles" / "1"
    sdir.mkdir(parents=True)
    for z in range(3):
        s = np.full((32, 30), 7, np.uint8)
        s[12:14, 11:17] = 63
        s[0:2, :] = 0
        Image.fromarray(s).save(str(sdir / f"s{z}.png"))
    return root.parent / "chaos_scribbles"


def _lvsc_tree(root: pathlib.Path):
    """Two LVSC patients of two 24x24 DICOMs with myocardium mask PNGs."""
    rs = np.random.RandomState(3)
    for pat in ("CAP_1", "CAP2"):
        pdir = root / pat
        pdir.mkdir(parents=True)
        for z in range(2):
            px = rs.randint(0, 500, (24, 24)).astype(np.uint16)
            (pdir / f"s{z}.dcm").write_bytes(make_dicom(px, spacing=(1.6, 1.6), instance=z + 1))
            m = np.zeros((24, 24), np.uint8)
            yy, xx = np.mgrid[:24, :24]
            r = np.hypot(yy - 12, xx - 12 - z)
            m[(r > 4) & (r < 8)] = 255
            Image.fromarray(m).save(str(pdir / f"s{z}.png"))


def _convert(module, dataset, raw, out, scribbles):
    if dataset == "acdc":
        return module.prepare_acdc(str(raw), str(out), scribble_dir=scribbles, size=24)
    if dataset == "acdc_native":
        return module.prepare_acdc(str(raw), str(out), scribble_dir=scribbles,
                                   target_mm=1.2)
    if dataset == "chaos":
        return module.prepare_chaos(str(raw), str(out), modality="t1",
                                    scribble_dir=scribbles, size=40)
    return module.prepare_lvsc(str(raw), str(out), target_mm=1.2)


@pytest.mark.parametrize("dataset", ["acdc", "acdc_native", "chaos", "lvsc"])
def test_prepare_data_is_byte_equal_to_jax(tmp_path, dataset):
    raw = tmp_path / "raw"
    scribbles = None
    if dataset.startswith("acdc"):
        scb_root = _fake_acdc_tree(raw, n_patients=3, scribbles=dataset == "acdc")
        scribbles = str(scb_root) if dataset == "acdc" else None
    elif dataset == "chaos":
        scribbles = str(_chaos_tree(raw))
    else:
        _lvsc_tree(raw)
    got = _convert(pd, dataset, raw, tmp_path / "port", scribbles)
    want = _convert(jax_pd, dataset, raw, tmp_path / "jax", scribbles)
    assert got == want and sum(len(v) for v in got.values()) >= 4
    _assert_trees_byte_equal(tmp_path / "port", tmp_path / "jax")


def test_prepare_data_cli_is_byte_equal_to_jax(tmp_path, capsys):
    raw = tmp_path / "raw"
    _fake_acdc_tree(raw, n_patients=2, scribbles=False)
    for main, out in ((cli.main, "port"), (jax_cli.main, "jax")):
        assert main(["acdc", "--raw_dir", str(raw), "--out_root", str(tmp_path / out),
                     "--size", "32", "--target_mm", "1.3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].replace("port", "jax") == lines[1]
    _assert_trees_byte_equal(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("command", ["generate", "shorten"])
def test_scribble_tools_cli_equals_jax(tmp_path, command):
    write_synthetic_dataset(str(tmp_path), "lvsc", 3, (32, 32), 2, 2, seed=1)
    in_dir = str(tmp_path / "lvsc" / "slices")
    for main, out in ((scribble_cli.main, "port"), (jax_scribble_cli.main, "jax")):
        argv = [command, "--in_dir", in_dir, "--out_dir", str(tmp_path / out),
                "--num_classes", "2", "--ignored_index", "2"]
        main(argv + (["--ratio", "0.5"] if command == "shorten" else []))
    _assert_trees_byte_equal(tmp_path / "port", tmp_path / "jax")


def test_readers_equal_jax(tmp_path):
    raw = tmp_path / "raw"
    _fake_acdc_tree(raw, n_patients=1, scribbles=False)
    _lvsc_tree(tmp_path / "lvsc")
    for path in sorted(raw.rglob("*.nii.gz")):
        (a, sa), (b, sb) = medio.read_nifti(str(path)), jax_medio.read_nifti(str(path))
        assert sa == sb and a.dtype == b.dtype and np.array_equal(a, b)
    files = medio.find_dicom_files(str(tmp_path / "lvsc"))
    assert files == jax_medio.find_dicom_files(str(tmp_path / "lvsc")) and len(files) == 4
    got = medio.read_dicom_series(files[:2], return_order=True)
    want = jax_medio.read_dicom_series(files[:2], return_order=True)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    vol = np.arange(60, dtype=np.int16).reshape(5, 4, 3)
    medio.write_nifti(str(tmp_path / "a.nii"), vol, (1.5, 2.0, 3.0))
    jax_medio.write_nifti(str(tmp_path / "b.nii"), vol, (1.5, 2.0, 3.0))
    assert (tmp_path / "a.nii").read_bytes() == (tmp_path / "b.nii").read_bytes()
    assert os.path.getsize(tmp_path / "a.nii") == 352 + vol.nbytes
