"""Five-fold cross-validation sweep runner.

The port of ``pacingpseudo_tpu/cli/sweep.py``: train each fold, run
inference on its test split from the fold's best checkpoint, and average
the folds, per slice and per patient (the reference's published protocol,
README tables):

    python -m pacingpseudo_torch.cli.sweep --dataset chaos --modality t1 \\
        --session Experiment --tag sweep1 --folds 0 1 2 3 4 \\
        --do_loss_ent --do_decoder_consistency --do_aux_path --do_memory

Every flag of ``cli.train`` plus ``--folds``, ``--sweep_out`` and
``--patient_regex``; ``--gpu`` names the devices as in ``cli.train``
(``0`` -> ``cuda:0``, the default; ``0,1`` trains each fold on two cards;
``cpu``), ``--num_devices`` and ``--spatial_shards`` split them for
training as there, and inference runs height-sharded over them with
``--spatial_shards`` above 1 (``evals/infer.py``), else on the first.  Each finished fold leaves ``fold{N}.json``, stamped
with :func:`_config_hash`, and a rerun with the same hash reads it instead
of training again.  Writes ``sweep_summary.json`` and a README-style
``sweep_table.md`` with per-fold and overall DSC / HD95.  The JAX
package's TPU lock and compile cache have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

# Run-placement and execution fields: a sweep moved, resumed or run with
# another dispatch keeps its cache.
_PLACEMENT = ("fold", "tag", "root", "resume", "run_dir", "profile_dir", "ckp_interval",
              "steps_per_dispatch", "device_resident_data", "num_devices", "spatial_shards")
# Dataset-defining and debug knobs that live on args, not on the config.
_ARGS_FIELDS = ("synthetic_data", "synthetic_difficulty", "synthetic_scribble_style",
                "synthetic_scribble_ratio", "synthetic_size_jitter", "max_steps_per_epoch")


def _config_hash(args, config_from_args) -> str:
    """Hash of every result-affecting knob, stamped into each cached
    ``fold{N}.json`` (JAX's ``_config_hash``, the same fields): a rerun with
    other hyperparameters regenerates instead of reusing stale folds.  Taken
    before ``main`` zeroes ``synthetic_data`` after writing the pool."""
    args = type(args)(**vars(args))  # shallow copy; config_from_args mutates
    args.fold = 0
    d = dataclasses.asdict(config_from_args(args))
    for k in _PLACEMENT:
        d.pop(k, None)
    d["patient_regex"] = args.patient_regex
    for k in _ARGS_FIELDS:
        d[k] = getattr(args, k, None)
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def build_parser():
    from pacingpseudo_torch.cli.train import build_parser as train_parser

    p = train_parser()
    p.add_argument("--folds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--sweep_out", type=str, default="")
    p.add_argument("--patient_regex", type=str, default="",
                   help="uid -> patient id regex for the per-patient "
                        "aggregation (evals/infer.py patient_key)")
    return p


def write_pool(args) -> None:
    """The ``--synthetic_data`` pool of the parsed ``args``, as ``main``
    writes it before the first fold (an identical pool already under
    ``--data_root`` is kept)."""
    from pacingpseudo_torch.config import DATASETS
    from pacingpseudo_torch.data.synthetic import write_synthetic_dataset
    spec = DATASETS[args.dataset]
    write_synthetic_dataset(
        args.data_root, args.dataset, args.synthetic_data,
        tuple(args.input_size) if args.input_size else spec.input_size,
        spec.num_classes, spec.ignored_index,
        modality=args.modality, seed=args.seed,
        size_jitter=args.synthetic_size_jitter,
        difficulty=args.synthetic_difficulty,
        scribble_style=args.synthetic_scribble_style,
        scribble_ratio=args.synthetic_scribble_ratio)


def main(argv=None):
    from pacingpseudo_torch.cli.train import config_from_args, devices_from_gpu
    from pacingpseudo_torch.evals.infer import run_inference
    from pacingpseudo_torch.train.loop import train_driver

    args = build_parser().parse_args(argv)
    devices = devices_from_gpu(args.gpu)
    # The pool's definition is part of the fold-cache key: a rerun that
    # only summarises must pass the same synthetic flags.
    cfg_hash = _config_hash(args, config_from_args)

    if args.synthetic_data:
        write_pool(args)
        args.synthetic_data = 0

    eval_ds = args.dataset
    if eval_ds == "chaos":
        eval_ds = "chaost1" if args.modality == "t1" else "chaost2"

    out_dir = args.sweep_out or os.path.join(args.root, f"sweep-{args.tag}")
    os.makedirs(out_dir, exist_ok=True)

    results = {}
    for fold in args.folds:
        # A finished fold leaves fold{N}.json and is skipped on a rerun, so
        # a crash mid-sweep costs only the fold in flight.
        fold_json = os.path.join(out_dir, f"fold{fold}.json")
        if os.path.exists(fold_json):
            with open(fold_json) as f:
                cached = json.load(f)
            if cached.get("_config_hash") == cfg_hash:
                results[fold] = cached
                print(f"fold {fold}: cached ({fold_json})")
                continue
            print(f"fold {fold}: cached result has config hash "
                  f"{cached.get('_config_hash')} != {cfg_hash}; regenerating")
        args.fold = fold
        config = config_from_args(args).validate()
        run_dir = train_driver(config, args.data_root,
                               max_steps_per_epoch=args.max_steps_per_epoch or None,
                               device=devices)
        infer_dir = os.path.join(run_dir, "inference")
        os.makedirs(infer_dir, exist_ok=True)
        res = run_inference(
            dataset=eval_ds, fold=fold, checkpoint_path=os.path.join(run_dir, "best_ckp"),
            data_root=args.data_root, run_dir=infer_dir,
            batch_size=max(args.batch_size, 1),
            model_kwargs=dict(
                input_ch=args.input_ch, init_ch=args.init_ch,
                max_ch=args.max_ch, output_stride=args.output_stride,
                is_stride_conv=args.is_stride_conv,
                is_trans_conv=args.is_trans_conv),
            compute_dtype=args.compute_dtype, patient_regex=args.patient_regex,
            device=devices, spatial_shards=args.spatial_shards,
            num_devices=args.num_devices)
        results[fold] = {"_config_hash": cfg_hash,
                         "dice": res["dice"], "hd95": res["hd95"],
                         "dice_per_patient": res["dice_per_patient"],
                         "hd95_per_patient": res["hd95_per_patient"],
                         "num_patients": res["num_patients"],
                         "run_dir": run_dir}
        with open(fold_json, "w") as f:
            json.dump(results[fold], f, indent=2)

    summary = summarize(eval_ds, args.session, args.folds, results)
    with open(os.path.join(out_dir, "sweep_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    table = sweep_table(args.folds, results, summary)
    with open(os.path.join(out_dir, "sweep_table.md"), "w") as f:
        f.write(table)
    print(table)
    return summary


def summarize(eval_ds: str, session: str, folds, results) -> dict:
    """The fold results and their averages: per slice (what both drivers
    log) and per patient (README.md:106), HD95 skipping NaN folds."""
    return {
        "dataset": eval_ds,
        "session": session,
        "folds": {str(f): results[f] for f in folds},
        "overall_dice": float(np.mean([results[f]["dice"] for f in folds])),
        "overall_hd95": float(np.nanmean([results[f]["hd95"] for f in folds])),
        "overall_dice_per_patient": float(np.mean(
            [results[f]["dice_per_patient"] for f in folds])),
        "overall_hd95_per_patient": float(np.nanmean(
            [results[f]["hd95_per_patient"] for f in folds])),
    }


def sweep_table(folds, results, summary) -> str:
    """The README-style markdown table: DSC and HD95 per fold and overall."""
    cols = " | ".join(f"Fold {f}" for f in folds)
    drow = " | ".join(f"{results[f]['dice']:.4f}" for f in folds)
    hrow = " | ".join(f"{results[f]['hd95']:.2f}" for f in folds)
    return (f"| Metric | {cols} | Overall |\n"
            f"|---|{'---|' * (len(folds) + 1)}\n"
            f"| DSC | {drow} | {summary['overall_dice']:.4f} |\n"
            f"| HD95 (mm) | {hrow} | {summary['overall_hd95']:.2f} |\n")


if __name__ == "__main__":
    main()
