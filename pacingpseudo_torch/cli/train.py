"""Training CLI -- argv-compatible with the reference drivers.

The port of ``pacingpseudo_tpu/cli/train.py``:

    python -m pacingpseudo_torch.cli.train --session Experiment --tag mytag \\
        --do_loss_ent --do_decoder_consistency --do_aux_path --do_memory

Every flag of the JAX package's parser, with its name and default
(reference train_chaos.py:23-179, upper_bound_chaos.py:81).  The device
is the reference's own ``--gpu``: a CUDA index (``0`` -> ``cuda:0``, the
default) or ``cpu``.  There is no fallback: without a CUDA device, ``--gpu
0`` fails.  The flags that only steer the JAX package's TPU execution
(``--s2d_hires``, ``--steps_per_dispatch``, ``--device_resident_data``,
``--spatial_shards``, ``--num_devices``, ``--profile_dir``) parse and are
ignored, and so are the TPU preflight and the XLA compile cache.
``--session Upperbound`` trains the fully supervised bare model
(upper_bound_chaos.py), with ``--loss_dice``.
"""
from __future__ import annotations

import argparse
import logging
import os
import random
import traceback

import numpy as np
import torch

from pacingpseudo_torch.config import DATASETS, ExperimentConfig


def _str2bool(v: str) -> bool:
    """Real boolean parsing for flags the reference declared ``type=bool``
    (train_chaos.py:74, upper_bound_chaos.py:81 — where ``--loss_dice False``
    silently parsed as True).  Accepts ``--flag``, ``--flag True``,
    ``--flag False`` (and 0/1/yes/no), so reference argv keeps working while
    the False spelling now actually disables the flag."""
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pacingpseudo_torch trainer")
    # Session (train_chaos.py:26-41)
    p.add_argument("--gpu", type=str, default="0",
                   help="the device: a CUDA index ('0' -> cuda:0) or 'cpu'")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--dataset", type=str, default="chaos",
                   choices=["chaos", "chaost1", "chaost2", "acdc", "lvsc"])
    p.add_argument("--root", type=str, default="./outputs/chaos")
    p.add_argument("--session", type=str, default="Control",
                   choices=["Control", "Experiment", "Upperbound"])
    p.add_argument("--tag", type=str, required=True)
    # Dataset (train_chaos.py:44-61)
    p.add_argument("--fold", type=int, default=1, choices=[0, 1, 2, 3, 4])
    p.add_argument("--modality", type=str, default="t1", choices=["t1", "t2"])
    p.add_argument("--num_classes", type=int, default=None,
                   help="defaults to the dataset's class count")
    p.add_argument("--num_workers", type=int, default=4,
                   help="host loader threads")
    p.add_argument("--augmentations", type=str, default="TransformsColor",
                   choices=["TransformsColor", "TransformsColorBlur",
                            "TransformsColorMixup", "TransformsColorLow"])
    # Network (train_chaos.py:65-84)
    p.add_argument("--input_ch", type=int, default=1)
    p.add_argument("--init_ch", type=int, default=32)
    p.add_argument("--max_ch", type=int, default=512)
    p.add_argument("--output_stride", type=int, default=8, choices=[32, 16, 8])
    p.add_argument("--is_stride_conv", action="store_true", default=False)
    p.add_argument("--is_trans_conv", action="store_true", default=False)
    p.add_argument("--elab_end_points", type=_str2bool, nargs="?",
                   const=True, default=True)
    # Optimizer (train_chaos.py:87-112)
    p.add_argument("--ignored_index", type=int, default=None)
    p.add_argument("--epoch", type=int, default=None,
                   help="defaults to 400 (40 for LVSC)")
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--optimizer", type=str, default="adam",
                   choices=["adam", "momentum"])
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_decay", type=str, default="poly",
                   choices=["linear", "poly", "cosine"])
    p.add_argument("--wd", type=float, default=3e-4)
    p.add_argument("--ckp_interval", type=int, default=10000)
    # Entropy minimisation (train_chaos.py:116-126)
    p.add_argument("--do_loss_ent", action="store_true", default=False)
    p.add_argument("--loss_ent_weight", type=float, default=1.0)
    # The reference declares these ``store_true`` with ``default=True``
    # (train_chaos.py:122,134) so the ramps could never be disabled;
    # BooleanOptionalAction keeps the enabling spelling argv-compatible and
    # adds a working ``--no-...`` disable (PARITY.md quirk entry).
    p.add_argument("--ramp_up_loss_ent", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--ramp_up_scale", type=float, default=8.0)
    # Consistency (train_chaos.py:129-145)
    p.add_argument("--do_decoder_consistency", action="store_true", default=False)
    p.add_argument("--ramp_up_loss_cr", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--detach_weak_cr", action="store_true", default=False)
    p.add_argument("--loss_cr_variants", type=str, default="ce_loss",
                   choices=["ce_loss", "l1_loss", "l2_loss", "kl_loss"])
    p.add_argument("--strength", type=float, default=1.0)
    p.add_argument("--loss_cr_weight", type=float, default=1.0)
    # Aux path (train_chaos.py:148-166)
    p.add_argument("--do_aux_path", action="store_true", default=False)
    p.add_argument("--feat_stage", type=str, nargs="+",
                   default=["encoder/stage6", "encoder/stage5"])
    p.add_argument("--loss_aux_weight", type=float, default=0.01)
    p.add_argument("--hid_ch", type=int, default=64)
    p.add_argument("--aux_drop_prob", type=float, default=0.0)
    # Memory bank (train_chaos.py:169-179)
    p.add_argument("--aux_on_strong", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="reference behaviour (default): aux path + memory "
                        "bank read the strong stream's encoder features when "
                        "the consistency branch runs (the torch UNet's "
                        "shared end_points dict is clobbered by the second "
                        "forward, unet.py:23); --no-aux_on_strong feeds them "
                        "the weak stream instead")
    p.add_argument("--do_memory", action="store_true", default=False)
    p.add_argument("--loss_memory_weight", type=float, default=1.0)
    p.add_argument("--update_momentum", type=float, default=0.9)
    p.add_argument("--ensemble_mode", type=str, default="cosine_similarity",
                   choices=["cosine_similarity", "mean"])
    # Upper bound (upper_bound_chaos.py:81)
    p.add_argument("--loss_dice", type=_str2bool, nargs="?",
                   const=True, default=True)
    # Extensions of the JAX package; the TPU-only ones parse and are ignored
    # by the port (config.py)
    p.add_argument("--data_root", type=str, default="./data")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--no_fuse_streams", action="store_true", default=False)
    p.add_argument("--memory_update_mode", type=str, default="first",
                   choices=["all", "first"],
                   help="'first' = the reference's actual behaviour (only "
                        "the first batch sample updates the memory bank, "
                        "aux_path_memory.py:116); 'all' = fixed-bug variant")
    p.add_argument("--ref_quirk_bn_eval_after_first_epoch", action="store_true",
                   default=False)
    p.add_argument("--reference_parity", action="store_true", default=False,
                   help="pin every parity-sensitive knob to the reference's "
                        "actual training dynamics: float32 compute, unfused "
                        "streams (per-stream BN stats), memory_update_mode="
                        "first, and the BN-eval-after-first-epoch quirk")
    p.add_argument("--num_devices", type=int, default=0)
    p.add_argument("--spatial_shards", type=int, default=0,
                   help="shard activation height over a 'space' mesh axis "
                        "(devices split as data x space); 0 = auto-factor "
                        "so all devices carry load at the given batch")
    p.add_argument("--aug_image_interp", type=str, default="bicubic",
                   choices=["bicubic", "bilinear"],
                   help="fused-warp image kernel: bicubic matches the "
                        "reference's cubic resamples (AUG_PARITY.json); "
                        "bilinear trades ~4%% throughput parity for speed")
    p.add_argument("--s2d_hires", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="space-to-depth execution of the high-res stage-1 "
                        "blocks (exact math, measured ~2.5x faster on TPU; "
                        "--no-s2d_hires restores the plain layout)")
    p.add_argument("--use_pallas_loss", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="fused Pallas loss kernel ('auto' resolves per "
                        "backend; 'off' is the CPU-sane choice)")
    p.add_argument("--tb_figures", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="per-epoch TB figure panels (host-side matplotlib "
                        "rendering; --no-tb_figures for throughput studies)")
    p.add_argument("--steps_per_dispatch", type=int, default=8)
    p.add_argument("--device_resident_data", type=str, default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--run_dir", type=str, default="",
                   help="use this exact run directory (required to --resume "
                        "an existing run; default: a fresh timestamped dir)")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="auto-resume the run after transient failures "
                        "(e.g. device backend hiccups) up to N times")
    p.add_argument("--max_steps_per_epoch", type=int, default=0,
                   help="debug: cap steps per epoch")
    p.add_argument("--synthetic_data", type=int, default=0,
                   help="generate N synthetic slices under --data_root first")
    p.add_argument("--synthetic_difficulty", type=str, default="easy",
                   choices=["easy", "hard", "jagged"],
                   help="phantom task difficulty (data/synthetic.py: 'hard' "
                        "= intensity-overlapping positional anatomy with "
                        "distractors, for the quality study; 'jagged' = "
                        "hard with star-deformed non-convex boundaries)")
    p.add_argument("--synthetic_scribble_style", type=str,
                   default="skeleton", choices=["skeleton", "dilated"],
                   help="synthetic scribble richness (tools/scribbles.py: "
                        "'dilated' approximates human stroke-width "
                        "scribbles; 'skeleton' is the reference's 1-px "
                        "LVSC protocol)")
    p.add_argument("--synthetic_scribble_ratio", type=float, default=1.0,
                   help="shorten every synthetic scribble stroke to this "
                        "fraction of its length (the reference's own "
                        "shortening-ablation knob, utils_shorten_scribble_"
                        "length.py; sparser supervision)")
    p.add_argument("--synthetic_size_jitter", type=int, default=0,
                   help="vary synthetic slice extents by +-N px (exercises "
                        "the heterogeneous-extent padding path; LVSC slices "
                        "are not uniformly sized, lvsc_aug_configs.py:18-63)")
    p.add_argument("--input_size", type=int, nargs=2, default=None,
                   help="override the dataset crop size (smoke runs)")
    p.add_argument("--profile_dir", type=str, default="",
                   help="accepted for CLI compatibility; not ported (the "
                        "JAX package writes a profiler trace here)")
    return p


def config_from_args(args) -> ExperimentConfig:
    spec = DATASETS[args.dataset]
    if getattr(args, "reference_parity", False):
        args.compute_dtype = "float32"
        args.no_fuse_streams = True
        args.memory_update_mode = "first"
        args.ref_quirk_bn_eval_after_first_epoch = True
    return ExperimentConfig(
        seed=args.seed,
        dataset=args.dataset,
        modality=args.modality,
        root=args.root,
        session=args.session,
        tag=args.tag,
        fold=args.fold,
        num_classes=args.num_classes or spec.num_classes,
        ignored_index=(args.ignored_index if args.ignored_index is not None
                       else spec.ignored_index),
        augmentations=args.augmentations,
        strength=args.strength,
        input_ch=args.input_ch,
        init_ch=args.init_ch,
        max_ch=args.max_ch,
        output_stride=args.output_stride,
        is_stride_conv=args.is_stride_conv,
        is_trans_conv=args.is_trans_conv,
        epoch=args.epoch or spec.default_epochs,
        batch_size=args.batch_size,
        optimizer=args.optimizer,
        momentum=args.momentum,
        lr=args.lr,
        lr_decay=args.lr_decay,
        wd=args.wd,
        ckp_interval=args.ckp_interval,
        do_loss_ent=args.do_loss_ent,
        loss_ent_weight=args.loss_ent_weight,
        ramp_up_loss_ent=args.ramp_up_loss_ent,
        ramp_up_scale=args.ramp_up_scale,
        do_decoder_consistency=args.do_decoder_consistency,
        ramp_up_loss_cr=args.ramp_up_loss_cr,
        detach_weak_cr=args.detach_weak_cr,
        loss_cr_variants=args.loss_cr_variants,
        loss_cr_weight=args.loss_cr_weight,
        do_aux_path=args.do_aux_path,
        aux_on_strong=args.aux_on_strong,
        feat_stage=tuple(args.feat_stage),
        loss_aux_weight=args.loss_aux_weight,
        hid_ch=args.hid_ch,
        aux_drop_prob=args.aux_drop_prob,
        do_memory=args.do_memory,
        loss_memory_weight=args.loss_memory_weight,
        update_momentum=args.update_momentum,
        ensemble_mode=args.ensemble_mode,
        loss_dice=args.loss_dice,
        compute_dtype=args.compute_dtype,
        fuse_streams=not args.no_fuse_streams,
        memory_update_mode=args.memory_update_mode,
        ref_quirk_bn_eval_after_first_epoch=args.ref_quirk_bn_eval_after_first_epoch,
        num_devices=args.num_devices,
        spatial_shards=args.spatial_shards,
        aug_image_interp=args.aug_image_interp,
        s2d_hires=args.s2d_hires,
        use_pallas_loss=args.use_pallas_loss,
        tb_figures=args.tb_figures,
        steps_per_dispatch=args.steps_per_dispatch,
        device_resident_data=args.device_resident_data,
        input_size=tuple(args.input_size) if args.input_size else None,
        resume=args.resume,
        profile_dir=args.profile_dir,
    )


def device_from_gpu(gpu: str) -> torch.device:
    """``--gpu``: ``cpu``, or one CUDA index (``"0"`` -> ``cuda:0``)."""
    if gpu.strip().lower() == "cpu":
        return torch.device("cpu")
    try:
        return torch.device("cuda", int(gpu))
    except ValueError:
        raise SystemExit(f"--gpu takes one CUDA index or 'cpu', got {gpu!r} "
                         "(training on several cards is not ported)") from None


def main(argv=None):
    args = build_parser().parse_args(argv)
    random.seed(args.seed)
    np.random.seed(args.seed)
    device = device_from_gpu(args.gpu)
    config = config_from_args(args).validate()

    if args.synthetic_data:
        from pacingpseudo_torch.data.synthetic import write_synthetic_dataset
        spec = DATASETS[config.dataset]
        write_synthetic_dataset(
            args.data_root, config.dataset, args.synthetic_data,
            tuple(args.input_size) if args.input_size else spec.input_size,
            config.num_classes, config.ignored_index,
            modality=config.modality, seed=config.seed,
            size_jitter=args.synthetic_size_jitter,
            difficulty=args.synthetic_difficulty,
            scribble_style=args.synthetic_scribble_style,
            scribble_ratio=args.synthetic_scribble_ratio)

    from pacingpseudo_torch.train.loop import make_run_dir, train_driver

    # Failure recovery: on a crash the run auto-resumes from its latest
    # checkpoint in the SAME run dir, up to --max_restarts times.
    # KeyboardInterrupt always propagates.
    if args.run_dir:
        run_dir = args.run_dir
        os.makedirs(os.path.join(run_dir, "ckps"), exist_ok=True)
    else:
        run_dir = make_run_dir(config)
    attempts = 0
    while True:
        try:
            return train_driver(
                config, args.data_root, run_dir=run_dir,
                max_steps_per_epoch=args.max_steps_per_epoch or None,
                device=device)
        except KeyboardInterrupt:
            raise
        except Exception:
            attempts += 1
            if attempts > args.max_restarts:
                raise
            logging.error("training attempt %d failed:\n%s",
                          attempts, traceback.format_exc())
            logging.error("restarting with resume (%d/%d)",
                          attempts, args.max_restarts)
            config.resume = True


if __name__ == "__main__":
    main()
