"""Minimal medical-image readers and writers: NIfTI-1 and uncompressed DICOM.

The port's own copy of ``pacingpseudo_tpu/tools/medio.py``, in pure numpy.
The raw challenge downloads are NIfTI volumes (ACDC and the vios-s
scribbles) and DICOM series (CHAOS, LVSC); nibabel and pydicom are not
dependencies, so ``tools/prepare_data.py`` reads them with these.

Scope: the subset of each format the three datasets use --

* NIfTI-1, optionally gzipped, little- or big-endian, datatypes
  {u8,i8,i16,u16,i32,u32,f32,f64}, scl_slope/scl_inter applied.
* DICOM: implicit- and explicit-VR little-endian transfer syntaxes with
  native (uncompressed) pixel data, 8/16-bit, signed or unsigned.
  Encapsulated (compressed) transfer syntaxes raise with a clear message.

Both readers return plain numpy arrays and the physical spacing.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# NIfTI-1
# ---------------------------------------------------------------------------

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32,
}


def read_nifti(path: str) -> Tuple[np.ndarray, Tuple[float, ...]]:
    """Read a .nii / .nii.gz volume.

    Returns ``(volume, spacing)`` where ``volume`` has the header's dim
    order (x, y, z[, t]) and ``spacing`` is ``pixdim[1:1+ndim]`` in mm.
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    if len(raw) < 348:
        raise ValueError(f"{path}: truncated NIfTI header ({len(raw)} bytes)")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr == 348:
        bo = "<"
    elif struct.unpack_from(">i", raw, 0)[0] == 348:
        bo = ">"
    else:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(bo + "8h", raw, 40)
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    datatype = struct.unpack_from(bo + "h", raw, 70)[0]
    if datatype not in _NIFTI_DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(bo)
    pixdim = struct.unpack_from(bo + "8f", raw, 76)
    vox_offset = int(struct.unpack_from(bo + "f", raw, 108)[0])
    scl_slope = struct.unpack_from(bo + "f", raw, 112)[0]
    scl_inter = struct.unpack_from(bo + "f", raw, 116)[0]
    if magic[:3] == b"ni1":            # detached header: data in .img
        img_path = path[:-len(".gz")] if path.endswith(".gz") else path
        img_path = os.path.splitext(img_path)[0] + ".img"
        with (gzip.open if os.path.exists(img_path + ".gz") else open)(
                img_path + (".gz" if os.path.exists(img_path + ".gz") else ""),
                "rb") as f:
            data = f.read()
        vox_offset = 0
    else:
        data = raw
        vox_offset = max(vox_offset, 352)

    n = int(np.prod(shape))
    buf = data[vox_offset:vox_offset + n * dtype.itemsize]
    if len(buf) < n * dtype.itemsize:
        raise ValueError(f"{path}: truncated voxel data")
    vol = np.frombuffer(buf, dtype=dtype).reshape(shape, order="F")
    vol = np.asarray(vol, dtype=vol.dtype.newbyteorder("="))
    if scl_slope not in (0.0, 1.0) or (scl_slope == 1.0 and scl_inter != 0.0):
        vol = vol.astype(np.float32) * scl_slope + scl_inter
    spacing = tuple(abs(float(p)) for p in pixdim[1:1 + ndim])
    return vol, spacing


def write_nifti(path: str, vol: np.ndarray,
                spacing: Sequence[float] = (1.0, 1.0, 1.0)) -> None:
    """Write a minimal single-file NIfTI-1 (.nii / .nii.gz).

    Used by the round-trip tests and handy for exporting predictions in a
    format the challenge evaluators accept.
    """
    vol = np.ascontiguousarray(vol)
    inv = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}
    if vol.dtype not in inv:
        vol = vol.astype(np.float32)
    datatype = inv[vol.dtype]
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [vol.ndim] + list(vol.shape) + [1] * (7 - vol.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, datatype)
    struct.pack_into("<h", hdr, 72, vol.dtype.itemsize * 8)
    pd = [1.0] + [float(s) for s in spacing[:vol.ndim]]
    pd += [1.0] * (8 - len(pd))
    struct.pack_into("<8f", hdr, 76, *pd)
    struct.pack_into("<f", hdr, 108, 352.0)          # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)            # scl_slope
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + vol.tobytes(order="F")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


# ---------------------------------------------------------------------------
# DICOM (implicit/explicit VR little endian, native pixel data)
# ---------------------------------------------------------------------------

_IMPLICIT_LE = "1.2.840.10008.1.2"
_EXPLICIT_LE = "1.2.840.10008.1.2.1"
# VRs whose explicit form uses a 2-byte reserved field + 4-byte length
_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR",
             b"UT", b"UN"}

_TAGS_OF_INTEREST = {
    (0x0008, 0x0060): "modality",
    (0x0010, 0x0020): "patient_id",
    (0x0020, 0x0013): "instance_number",
    (0x0020, 0x1041): "slice_location",
    (0x0028, 0x0010): "rows",
    (0x0028, 0x0011): "cols",
    (0x0028, 0x0030): "pixel_spacing",
    (0x0028, 0x0100): "bits_allocated",
    (0x0028, 0x0103): "pixel_representation",
    (0x0028, 0x1052): "rescale_intercept",
    (0x0028, 0x1053): "rescale_slope",
    (0x0018, 0x0050): "slice_thickness",
    (0x0018, 0x0088): "spacing_between_slices",
    (0x7FE0, 0x0010): "pixel_data",
}


def _skip_undefined_sequence(buf: bytes, pos: int) -> int:
    """Advance past an undefined-length sequence (nested items allowed)."""
    depth = 1
    n = len(buf)
    while pos + 8 <= n and depth > 0:
        group, elem = struct.unpack_from("<HH", buf, pos)
        length = struct.unpack_from("<I", buf, pos + 4)[0]
        pos += 8
        if (group, elem) == (0xFFFE, 0xE0DD):        # SequenceDelimitation
            depth -= 1
        elif (group, elem) == (0xFFFE, 0xE000):      # Item
            if length == 0xFFFFFFFF:
                continue                              # delimited item
            pos += length
        elif (group, elem) == (0xFFFE, 0xE00D):      # ItemDelimitation
            continue
        else:                                         # nested undefined SQ
            if length == 0xFFFFFFFF:
                depth += 1
            else:
                pos += length
    return pos


def _parse_elements(buf: bytes, pos: int, explicit: bool,
                    stop_at_pixels: bool = False) -> Dict[str, bytes]:
    out: Dict[str, bytes] = {}
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        pos += 4
        vr = b""
        if explicit and group != 0xFFFE:
            vr = buf[pos:pos + 2]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", buf, pos + 2)[0]
                pos += 4
        else:
            length = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        if length == 0xFFFFFFFF:
            if (group, elem) == (0x7FE0, 0x0010):
                raise ValueError(
                    "Encapsulated (compressed) DICOM pixel data is not "
                    "supported; decompress the series first (e.g. with "
                    "dcmtk's dcmdjpeg) or install pydicom+handlers.")
            pos = _skip_undefined_sequence(buf, pos)
            continue
        key = _TAGS_OF_INTEREST.get((group, elem))
        if key is not None:
            out[key] = buf[pos:pos + length]
            if key == "pixel_data" and stop_at_pixels:
                return out
        pos += length
    return out


def _decode_number(raw: bytes, default: float = 0.0) -> float:
    s = raw.decode("ascii", "ignore").strip().strip("\x00")
    try:
        return float(s)
    except ValueError:
        return default


def read_dicom(path: str) -> Dict[str, object]:
    """Parse one DICOM file → dict with ``pixels`` (H, W) float32 (rescale
    applied), ``spacing`` (row, col) mm, ``instance_number``,
    ``slice_location``, ``patient_id``."""
    with open(path, "rb") as f:
        buf = f.read()
    transfer = _IMPLICIT_LE
    pos = 0
    if len(buf) > 132 and buf[128:132] == b"DICM":
        pos = 132
        # File-meta group (0002,xxxx): always explicit VR little endian.
        meta_end = len(buf)
        probe = pos
        while probe + 8 <= len(buf):
            group, elem = struct.unpack_from("<HH", buf, probe)
            if group != 0x0002:
                meta_end = probe
                break
            vr = buf[probe + 4:probe + 6]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, probe + 8)[0]
                body = probe + 12
            else:
                length = struct.unpack_from("<H", buf, probe + 6)[0]
                body = probe + 8
            if (group, elem) == (0x0002, 0x0010):
                transfer = buf[body:body + length].decode(
                    "ascii", "ignore").strip().strip("\x00")
            probe = body + length
            meta_end = probe
        pos = meta_end
    if transfer not in (_IMPLICIT_LE, _EXPLICIT_LE):
        raise ValueError(
            f"{path}: transfer syntax {transfer} not supported (only "
            f"implicit/explicit VR little endian, uncompressed)")
    explicit = transfer == _EXPLICIT_LE
    if pos == 0:
        # No preamble: sniff implicit vs explicit from the first element's VR.
        vr = buf[4:6]
        explicit = vr.isalpha() and vr.isupper()
    el = _parse_elements(buf, pos, explicit)
    if "pixel_data" not in el or "rows" not in el or "cols" not in el:
        raise ValueError(f"{path}: missing Rows/Columns/PixelData")
    rows = struct.unpack("<H", el["rows"][:2])[0]
    cols = struct.unpack("<H", el["cols"][:2])[0]
    bits = struct.unpack("<H", el["bits_allocated"][:2])[0] \
        if "bits_allocated" in el else 16
    signed = bool(struct.unpack("<H", el["pixel_representation"][:2])[0]) \
        if "pixel_representation" in el else False
    dtype = {8: np.int8 if signed else np.uint8,
             16: np.int16 if signed else np.uint16}.get(bits)
    if dtype is None:
        raise ValueError(f"{path}: BitsAllocated={bits} not supported")
    need = rows * cols * np.dtype(dtype).itemsize
    raw_px = el["pixel_data"][:need]
    if len(raw_px) < need:
        raise ValueError(f"{path}: truncated pixel data")
    px = np.frombuffer(raw_px, dtype=dtype).reshape(rows, cols)
    px = px.astype(np.float32)
    slope = _decode_number(el.get("rescale_slope", b"1"), 1.0) or 1.0
    inter = _decode_number(el.get("rescale_intercept", b"0"), 0.0)
    if slope != 1.0 or inter != 0.0:
        px = px * slope + inter
    spacing = (1.0, 1.0)
    if "pixel_spacing" in el:
        parts = el["pixel_spacing"].decode("ascii", "ignore").split("\\")
        if len(parts) >= 2:
            spacing = (float(parts[0]), float(parts[1]))
    return {
        "pixels": px,
        "spacing": spacing,
        "instance_number": int(_decode_number(
            el.get("instance_number", b"0"))),
        "slice_location": _decode_number(
            el.get("slice_location", b"nan"), float("nan")),
        "patient_id": el.get("patient_id", b"").decode(
            "ascii", "ignore").strip().strip("\x00"),
    }


def read_dicom_series(paths: Sequence[str], return_order: bool = False):
    """Read + sort a DICOM series → ``(volume (Z, H, W) float32, spacing)``.

    Slices sort by InstanceNumber (falling back to SliceLocation, then to
    filename) — the in-plane ordering the reference's per-slice export
    implies.

    ``return_order=True`` additionally returns the file paths in the SAME
    order as the stacked volume, so callers pairing per-slice masks (by
    stem or by parallel filename-sorted lists) can keep image/mask slices
    aligned even when instance order differs from lexicographic order
    (e.g. ``..._ph2.dcm`` sorting after ``..._ph10.dcm``).
    """
    if not paths:
        raise ValueError("empty DICOM series")
    slices: List[Tuple[tuple, np.ndarray, Tuple[float, float], str]] = []
    for i, p in enumerate(sorted(paths)):
        d = read_dicom(p)
        key = (d["instance_number"],
               d["slice_location"] if d["slice_location"] == d["slice_location"]
               else 0.0, i)
        slices.append((key, d["pixels"], d["spacing"], p))
    slices.sort(key=lambda t: t[0])
    shapes = {s[1].shape for s in slices}
    if len(shapes) != 1:
        raise ValueError(f"inconsistent slice shapes in series: {shapes}")
    vol = np.stack([s[1] for s in slices])
    if return_order:
        return vol, slices[0][2], [s[3] for s in slices]
    return vol, slices[0][2]


def find_dicom_files(root: str) -> List[str]:
    """All .dcm / .IMA files under ``root`` (case-insensitive), sorted."""
    out = []
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.lower().endswith((".dcm", ".ima")):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)
