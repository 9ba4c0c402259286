"""Raw challenge data -> the per-slice ``.npz`` training layout.

The port's own copy of ``pacingpseudo_tpu/tools/prepare_data.py``.  The
reference describes this step in prose only ("Resample pixel sizes to
1.62x1.62mm², crop or pad the axial view to 256x256, save the 3D volumes
slice by slice in .npz format, split slices into five folds at patient
level", reference README.md:13-19); this module does it for the three
datasets:

    <out_root>/<ds>/slices/<uid>.npz            keys: uid / img / lab / scb
    <out_root>/<ds>/train_test_split/five_fold_split[/<modality>]/
        {train,test}_fold{0..4}.txt             patient-level folds

The raw formats are read by ``tools/medio.py``:

* **ACDC**: NIfTI frames ``patientXXX/patientXXX_frameYY.nii.gz`` with
  ``..._gt.nii.gz`` dense labels; scribbles from the vios-s release
  (``..._scribble.nii.gz``, values 0..3 = classes, 4 = unannotated).
* **CHAOS** (MR T1-DUAL / T2-SPIR): DICOM series under
  ``<patient>/T1DUAL/DICOM_anon/InPhase`` (T2SPIR: no InPhase level) with
  intensity-coded ``Ground`` PNGs (liver 55-70, right kidney 110-135, left
  kidney 175-200, spleen 240-255 -> classes 1..4, the reference's
  chaos_dataset.py:17-24 order); manual scribbles as same-coded PNGs.
* **LVSC**: DICOM images and binary myocardium masks; scribbles are
  artificial (reference README.md:11), from ``tools.scribbles
  .generate_scribble``, the same skeletonisation protocol.

uids are ``<patient>_<suffix>``, so ``evals.infer.aggregate_per_patient``'s
default patient key (``uid.split('_')[0]``) applies.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy import ndimage

from pacingpseudo_torch.tools.medio import find_dicom_files, read_dicom_series, read_nifti
from pacingpseudo_torch.tools.scribbles import generate_scribble

# Published in-plane target spacings (reference inference.py:55-60).
TARGET_SPACING = {"chaos": 1.62, "acdc": 1.51, "lvsc": 1.48}

# CHAOS MR Ground PNG intensity ranges → class index (CHAOS data docs).
_CHAOS_RANGES = ((55, 70, 1), (110, 135, 2), (175, 200, 3), (240, 255, 4))


def resample_inplane(sl: np.ndarray, spacing: Tuple[float, float],
                     target_mm: float, order: int) -> np.ndarray:
    """Resample one (H, W) slice to isotropic ``target_mm`` pixels.

    order=3 cubic for images, order=0 nearest for label/scribble masks
    (class values must survive exactly).
    """
    zoom = (spacing[0] / target_mm, spacing[1] / target_mm)
    if abs(zoom[0] - 1) < 1e-6 and abs(zoom[1] - 1) < 1e-6:
        return sl
    return ndimage.zoom(sl, zoom, order=order, mode="nearest",
                        grid_mode=True)


def crop_or_pad(arr: np.ndarray, size: int, pad_value: float) -> np.ndarray:
    """Center crop-or-pad an (H, W) slice to (size, size)."""
    h, w = arr.shape
    out = np.full((size, size), pad_value, dtype=arr.dtype)
    sy = max(0, (h - size) // 2)
    sx = max(0, (w - size) // 2)
    dy = max(0, (size - h) // 2)
    dx = max(0, (size - w) // 2)
    ch = min(h, size)
    cw = min(w, size)
    out[dy:dy + ch, dx:dx + cw] = arr[sy:sy + ch, sx:sx + cw]
    return out


def chaos_png_to_label(png: np.ndarray) -> np.ndarray:
    """Decode a CHAOS MR intensity-coded ground-truth PNG to class ids."""
    lab = np.zeros(png.shape, np.uint8)
    for lo, hi, cls in _CHAOS_RANGES:
        lab[(png >= lo) & (png <= hi)] = cls
    return lab


def save_slice_npz(slices_dir: str, uid: str, img: np.ndarray,
                   lab: np.ndarray, scb: np.ndarray) -> str:
    os.makedirs(slices_dir, exist_ok=True)
    path = os.path.join(slices_dir, f"{uid}.npz")
    np.savez_compressed(path, uid=uid, img=img.astype(np.float32),
                        lab=lab.astype(np.float32),
                        scb=scb.astype(np.float32))
    return path


def write_five_fold_splits(ds_root: str, patient_files: Dict[str, List[str]],
                           modality: str = "", folds: int = 5) -> None:
    """Patient-level folds (reference README.md:19): sorted patients
    round-robin into ``folds`` test sets; txt lines are paths relative to
    the dataset root (train_chaos.py:455-461 / data/splits.py)."""
    base = os.path.join(ds_root, "train_test_split", "five_fold_split")
    if modality:
        base = os.path.join(base, modality)
    os.makedirs(base, exist_ok=True)
    patients = sorted(patient_files)
    for fold in range(folds):
        test_p = set(patients[fold::folds])
        train, test = [], []
        for p in patients:
            (test if p in test_p else train).extend(
                sorted(patient_files[p]))
        for name, rows in (("train", train), ("test", test)):
            with open(os.path.join(base, f"{name}_fold{fold}.txt"), "w") as f:
                f.write("".join(r + "\n" for r in rows))


def _emit_volume(ds_root: str, pid: str, suffix: str, img_vol: np.ndarray,
                 lab_vol: np.ndarray, scb_vol: Optional[np.ndarray],
                 spacing: Tuple[float, float], target_mm: float,
                 ignored_index: int, size: Optional[int],
                 skip_empty: bool = False) -> List[str]:
    """Resample + crop/pad + save every slice of one (Z, H, W) volume.

    ``scb_vol=None`` → artificial scribbles from the dense label (the LVSC
    protocol).  Returns the emitted paths relative to ``ds_root``.
    """
    assert img_vol.shape == lab_vol.shape, (img_vol.shape, lab_vol.shape)
    num_classes = ignored_index
    rel_paths = []
    slices_dir = os.path.join(ds_root, "slices")
    for z in range(img_vol.shape[0]):
        img = resample_inplane(img_vol[z].astype(np.float32), spacing,
                               target_mm, order=3)
        lab = resample_inplane(lab_vol[z].astype(np.uint8), spacing,
                               target_mm, order=0)
        if scb_vol is not None:
            scb = resample_inplane(scb_vol[z].astype(np.uint8), spacing,
                                   target_mm, order=0)
        else:
            scb = generate_scribble(lab.astype(np.int32), num_classes,
                                    ignored_index).astype(np.uint8)
        if size is not None:
            img = crop_or_pad(img, size, 0.0)
            lab = crop_or_pad(lab, size, 0)
            scb = crop_or_pad(scb, size, ignored_index)
        if skip_empty and not lab.any():
            continue
        uid = f"{pid}_{suffix}s{z:03d}"
        save_slice_npz(slices_dir, uid, img, lab, scb)
        rel_paths.append(os.path.join("slices", f"{uid}.npz"))
    return rel_paths


# ---------------------------------------------------------------------------
# Dataset adapters
# ---------------------------------------------------------------------------

def prepare_acdc(raw_dir: str, out_root: str,
                 scribble_dir: Optional[str] = None,
                 target_mm: Optional[float] = None,
                 size: Optional[int] = None) -> Dict[str, List[str]]:
    """ACDC NIfTI frames (+ optional vios-s scribbles) → npz layout.

    Frames: every ``patient*/*_frameNN.nii.gz`` with a ``_gt`` sibling.
    Scribble volumes (``*_scribble.nii.gz``) use 0..3 = classes and 4 =
    unannotated, which IS the ignored_index convention — copied through.
    Without scribbles, artificial ones are generated (for smoke runs).
    """
    target_mm = target_mm or TARGET_SPACING["acdc"]
    ds_root = os.path.join(out_root, "acdc")
    patient_files: Dict[str, List[str]] = {}
    gts = sorted(glob.glob(os.path.join(
        raw_dir, "patient*", "*_frame*_gt.nii.gz")))
    if not gts:
        raise FileNotFoundError(
            f"no ACDC ground-truth frames under {raw_dir} "
            "(expected patientXXX/patientXXX_frameYY_gt.nii.gz)")
    for gt_path in gts:
        img_path = gt_path.replace("_gt.nii.gz", ".nii.gz")
        if not os.path.exists(img_path):
            continue
        m = re.search(r"(patient\d+)_frame(\d+)", os.path.basename(gt_path))
        pid, frame = m.group(1), m.group(2)
        img_vol, sp = read_nifti(img_path)
        lab_vol, _ = read_nifti(gt_path)
        scb_vol = None
        if scribble_dir:
            cands = glob.glob(os.path.join(
                scribble_dir, "**", f"{pid}_frame{frame}_scribble.nii.gz"),
                recursive=True)
            if cands:
                scb_raw, _ = read_nifti(cands[0])
                scb_vol = np.transpose(np.asarray(scb_raw, np.uint8),
                                       (2, 1, 0))
        # NIfTI (x, y, z) → (z, y, x) slice stacks; in-plane spacing (sy, sx).
        img_zyx = np.transpose(np.asarray(img_vol, np.float32), (2, 1, 0))
        lab_zyx = np.transpose(np.asarray(lab_vol, np.uint8), (2, 1, 0))
        rel = _emit_volume(ds_root, pid, f"frame{frame}", img_zyx, lab_zyx,
                           scb_vol, (sp[1], sp[0]), target_mm,
                           ignored_index=4, size=size)
        patient_files.setdefault(pid, []).extend(rel)
    write_five_fold_splits(ds_root, patient_files)
    return patient_files


def prepare_chaos(raw_dir: str, out_root: str, modality: str = "t1",
                  scribble_dir: Optional[str] = None,
                  target_mm: Optional[float] = None,
                  size: int = 256) -> Dict[str, List[str]]:
    """CHAOS MR DICOM series + Ground PNGs → npz layout (256², 1.62 mm).

    ``raw_dir`` is the challenge's ``Train_Sets/MR``; each patient dir has
    ``T1DUAL/DICOM_anon/InPhase`` (or ``T2SPIR/DICOM_anon``) and a
    ``Ground`` PNG per slice.  ``scribble_dir/<patient>/*.png`` supplies
    manual scribbles in the same intensity coding (value ≥ 254 or the
    CHAOS ranges; anything uncoded → unknown=5); absent → artificial.
    """
    from PIL import Image

    target_mm = target_mm or TARGET_SPACING["chaos"]
    ds_root = os.path.join(out_root, "chaos")
    seq = "T1DUAL" if modality.lower() == "t1" else "T2SPIR"
    patient_files: Dict[str, List[str]] = {}
    patients = sorted(d for d in os.listdir(raw_dir)
                      if os.path.isdir(os.path.join(raw_dir, d, seq)))
    if not patients:
        raise FileNotFoundError(f"no CHAOS patients with {seq} under {raw_dir}")
    for pat in patients:
        dicom_root = os.path.join(raw_dir, pat, seq, "DICOM_anon")
        if os.path.isdir(os.path.join(dicom_root, "InPhase")):
            dicom_root = os.path.join(dicom_root, "InPhase")
        files = find_dicom_files(dicom_root)
        if not files:
            continue
        vol, sp, ordered = read_dicom_series(files, return_order=True)
        # Ground PNGs pair with DICOMs positionally when both lists are
        # filename-sorted; the volume itself is stacked in INSTANCE order,
        # so apply the same filename→instance permutation to the masks.
        perm = [sorted(files).index(p) for p in ordered]
        ground = sorted(glob.glob(os.path.join(
            raw_dir, pat, seq, "Ground", "*.png")))
        if len(ground) != vol.shape[0]:
            raise ValueError(
                f"{pat}: {len(ground)} Ground PNGs vs {vol.shape[0]} DICOMs")
        lab_vol = np.stack([chaos_png_to_label(np.asarray(Image.open(
            ground[i]))) for i in perm])
        scb_vol = None
        if scribble_dir:
            scbs = sorted(glob.glob(os.path.join(scribble_dir, pat, "*.png")))
            if len(scbs) == vol.shape[0]:
                coded = np.stack([np.asarray(Image.open(scbs[i]))
                                  for i in perm])
                scb_vol = np.full(coded.shape, 5, np.uint8)
                scb_vol[coded == 0] = 0            # background strokes
                for lo, hi, cls in _CHAOS_RANGES:
                    scb_vol[(coded >= lo) & (coded <= hi)] = cls
        pid = f"c{modality.lower()}{int(pat) if pat.isdigit() else pat}"
        rel = _emit_volume(ds_root, pid, "", vol, lab_vol, scb_vol, sp,
                           target_mm, ignored_index=5, size=size)
        patient_files.setdefault(pid, []).extend(rel)
    write_five_fold_splits(ds_root, patient_files, modality=modality.lower())
    return patient_files


def prepare_lvsc(raw_dir: str, out_root: str, mask_dir: Optional[str] = None,
                 target_mm: Optional[float] = None,
                 size: Optional[int] = None) -> Dict[str, List[str]]:
    """LVSC DICOMs + binary myocardium masks → npz with ARTIFICIAL scribbles.

    ``raw_dir/<patient>/*.dcm`` images; masks as PNGs either next to each
    DICOM (same stem) or mirrored under ``mask_dir``.  Scribbles always
    come from ``generate_scribble`` (reference README.md:11 "Artificial";
    utils_artificial_scribbles.py protocol).
    """
    from PIL import Image

    target_mm = target_mm or TARGET_SPACING["lvsc"]
    ds_root = os.path.join(out_root, "lvsc")
    patient_files: Dict[str, List[str]] = {}
    patients = sorted(d for d in os.listdir(raw_dir)
                      if os.path.isdir(os.path.join(raw_dir, d)))
    if not patients:
        raise FileNotFoundError(f"no LVSC patient dirs under {raw_dir}")
    for pat in patients:
        files = find_dicom_files(os.path.join(raw_dir, pat))
        if not files:
            continue
        # Masks pair with DICOMs by file stem; iterate in the VOLUME's
        # (instance-sorted) order so lab_vol[z] matches vol[z] even when
        # instance order differs from lexicographic filename order.
        vol, sp, ordered = read_dicom_series(files, return_order=True)
        masks = []
        for f in ordered:
            stem = os.path.splitext(os.path.basename(f))[0]
            cands = [os.path.splitext(f)[0] + ".png"]
            if mask_dir:
                cands.append(os.path.join(mask_dir, pat, stem + ".png"))
            mask_path = next((c for c in cands if os.path.exists(c)), None)
            if mask_path is None:
                raise FileNotFoundError(f"no mask for {f}")
            masks.append((np.asarray(Image.open(mask_path)) > 0)
                         .astype(np.uint8))
        lab_vol = np.stack(masks)
        pid = pat.replace("_", "")
        rel = _emit_volume(ds_root, pid, "", vol, lab_vol, None, sp,
                           target_mm, ignored_index=2, size=size)
        patient_files.setdefault(pid, []).extend(rel)
    write_five_fold_splits(ds_root, patient_files)
    return patient_files
