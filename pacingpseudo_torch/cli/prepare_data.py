"""Raw challenge downloads -> the training ``.npz`` layout (CLI).

The port of ``pacingpseudo_tpu/cli/prepare_data.py``, the same argv:

  python -m pacingpseudo_torch.cli.prepare_data acdc \\
      --raw_dir ~/ACDC/training --scribble_dir ~/acdc_scribbles \\
      --out_root ./data
  python -m pacingpseudo_torch.cli.prepare_data chaos \\
      --raw_dir ~/CHAOS/Train_Sets/MR --modality t1 --out_root ./data
  python -m pacingpseudo_torch.cli.prepare_data lvsc \\
      --raw_dir ~/LVSC/images --mask_dir ~/LVSC/masks --out_root ./data

It resamples to the published in-plane spacing, optionally crops or pads,
writes one npz a slice (uid/img/lab/scb) and the patient-level five-fold
split files (reference README.md:13-19).  Training reads the layout:

  python -m pacingpseudo_torch.cli.train --session Experiment --fold 0 \\
      --modality t1 --data_root ./data ...
"""
from __future__ import annotations

import argparse
import sys

from pacingpseudo_torch.tools import prepare_data as pd


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="prepare_data",
        description="Convert raw CHAOS/ACDC/LVSC downloads to the per-slice "
                    ".npz layout + five-fold splits the drivers consume.")
    sub = p.add_subparsers(dest="dataset", required=True)

    a = sub.add_parser("acdc", help="ACDC NIfTI frames (+ vios-s scribbles)")
    a.add_argument("--raw_dir", required=True,
                   help="ACDC 'training' dir (patientXXX/...)")
    a.add_argument("--scribble_dir", default=None,
                   help="vios-s scribble release root (optional; artificial "
                        "scribbles are generated when absent)")
    a.add_argument("--size", type=int, default=None,
                   help="center crop/pad to SIZE² (default: keep native "
                        "extents; RandomCrop handles them at train time)")

    c = sub.add_parser("chaos", help="CHAOS MR DICOM series + Ground PNGs")
    c.add_argument("--raw_dir", required=True,
                   help="CHAOS Train_Sets/MR dir (patient numbers)")
    c.add_argument("--modality", choices=["t1", "t2"], default="t1")
    c.add_argument("--scribble_dir", default=None,
                   help="manual scribble PNGs mirrored per patient "
                        "(optional; artificial when absent)")
    c.add_argument("--size", type=int, default=256,
                   help="published CHAOS canvas (README.md:17)")

    l = sub.add_parser("lvsc", help="LVSC DICOMs + binary myo masks")
    l.add_argument("--raw_dir", required=True)
    l.add_argument("--mask_dir", default=None,
                   help="mask PNG tree mirroring the DICOM layout "
                        "(default: PNGs next to each DICOM)")
    l.add_argument("--size", type=int, default=None)

    for s in (a, c, l):
        s.add_argument("--out_root", default="./data")
        s.add_argument("--target_mm", type=float, default=None,
                       help="in-plane spacing override (defaults: chaos "
                            "1.62 / acdc 1.51 / lvsc 1.48 — inference.py"
                            ":55-60)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.dataset == "acdc":
        pf = pd.prepare_acdc(args.raw_dir, args.out_root,
                             scribble_dir=args.scribble_dir,
                             target_mm=args.target_mm, size=args.size)
    elif args.dataset == "chaos":
        pf = pd.prepare_chaos(args.raw_dir, args.out_root,
                              modality=args.modality,
                              scribble_dir=args.scribble_dir,
                              target_mm=args.target_mm, size=args.size)
    else:
        pf = pd.prepare_lvsc(args.raw_dir, args.out_root,
                             mask_dir=args.mask_dir,
                             target_mm=args.target_mm, size=args.size)
    n = sum(len(v) for v in pf.values())
    print(f"{args.dataset}: wrote {n} slices from {len(pf)} patients "
          f"under {args.out_root}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
