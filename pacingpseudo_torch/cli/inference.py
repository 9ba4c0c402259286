"""Inference CLI -- argv-compatible with the reference ``inference.py``.

The port of ``pacingpseudo_tpu/cli/inference.py``:

    python -m pacingpseudo_torch.cli.inference --dataset chaost1 --fold 0 \\
        --checkpoint_file <run_dir> [--best_ckp]

resolves the checkpoint (best or final epoch, ``resolve_checkpoint_path``),
asserts that its path names the fold (reference inference.py:269), and
writes per-slice DSC and HD95 to ``eval_data.npz`` under
``<root>/<session>/<dataset>/<checkpoint dir name>/``.  ``--checkpoint_file``
may also name a checkpoint directory or a reference ``.pth`` state_dict.

Every flag of the JAX package's parser, with one stated difference:
``--gpu`` is the device, as in the port's train CLI, a CUDA index or
``cpu``, and its default is ``0``, not the ignored ``1`` of JAX (a card
with one device has no ``cuda:1``).  ``--spatial_shards`` above 1 (height
sharded over several devices) is refused: the multi-card path is
``ROADMAP.md`` Queue 1 item 8.
"""
from __future__ import annotations

import argparse
import logging
import os
import random
import sys

import numpy as np

from pacingpseudo_torch.cli.train import device_from_gpu
from pacingpseudo_torch.train.checkpoint import MODEL_FILE, resolve_checkpoint_path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pacingpseudo_torch inference")
    p.add_argument("--gpu", type=str, default="0",
                   help="the device: a CUDA index ('0' -> cuda:0) or 'cpu'")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--root", type=str, default="./outputs")
    p.add_argument("--session", type=str, default="Inference")
    p.add_argument("--fold", type=int, required=True)
    p.add_argument("--checkpoint_file", type=str, required=True)
    p.add_argument("--best_ckp", action="store_true", default=False)
    p.add_argument("--dataset", type=str, default="acdc",
                   choices=["acdc", "chaost1", "chaost2", "lvsc"])
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=8)
    # Backbone (inference.py:76-95)
    p.add_argument("--input_ch", type=int, default=1)
    p.add_argument("--init_ch", type=int, default=32)
    p.add_argument("--max_ch", type=int, default=512)
    p.add_argument("--output_stride", type=int, default=8, choices=[32, 16, 8])
    p.add_argument("--is_stride_conv", action="store_true", default=False)
    p.add_argument("--is_trans_conv", action="store_true", default=False)
    # Extensions of the JAX package
    p.add_argument("--data_root", type=str, default="./data")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--spatial_shards", type=int, default=1,
                   help="1 only: sharding over several devices is not ported")
    p.add_argument("--patient_regex", type=str, default="",
                   help="regex whose first capture group maps a slice uid to "
                        "its patient id for the per-patient aggregation "
                        "(default: first '_'-separated token)")
    p.add_argument("--save_pred", action="store_true", default=False,
                   help="also write each slice's hard prediction to "
                        "<run_dir>/preds/<uid>.npz (uint8, cropped to the "
                        "slice's true extent)")
    return p


def resolve(checkpoint_file: str, dataset: str, best: bool) -> str:
    """The checkpoint that ``--checkpoint_file`` names: a run directory
    resolves to its best or final-epoch checkpoint where that exists; a
    checkpoint directory or a state_dict file is taken as it is."""
    if (os.path.isdir(checkpoint_file)
            and not os.path.isfile(os.path.join(checkpoint_file, MODEL_FILE))):
        resolved = resolve_checkpoint_path(checkpoint_file, dataset, best)
        if os.path.exists(resolved):
            return resolved
    return checkpoint_file


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.spatial_shards > 1:
        raise SystemExit("--spatial_shards > 1 shards inference over several devices, "
                         "which is not ported (ROADMAP.md Queue 1 item 8)")
    device = device_from_gpu(args.gpu)
    random.seed(args.seed)
    np.random.seed(args.seed)

    # fold/checkpoint alignment (inference.py:269)
    if f"fold{args.fold}" not in args.checkpoint_file:
        raise SystemExit(f"checkpoint path must contain fold{args.fold}")
    ckpt_path = resolve(args.checkpoint_file, args.dataset, args.best_ckp)

    run_dir = os.path.join(args.root, args.session, args.dataset,
                           os.path.basename(os.path.normpath(args.checkpoint_file)))
    os.makedirs(run_dir, exist_ok=True)
    logging.basicConfig(
        filename=os.path.join(run_dir, "log.txt"), level=logging.INFO,
        filemode="w", format="[%(asctime)s.%(msecs)03d] %(message)s",
        datefmt="%H:%M:%S", force=True)
    logging.getLogger().addHandler(logging.StreamHandler(sys.stdout))
    logging.info("args: %s", vars(args))
    logging.info("checkpoint: %s", ckpt_path)

    from pacingpseudo_torch.evals.infer import run_inference
    return run_inference(
        dataset=args.dataset, fold=args.fold, checkpoint_path=ckpt_path,
        data_root=args.data_root, run_dir=run_dir, batch_size=args.batch_size,
        model_kwargs=dict(input_ch=args.input_ch, init_ch=args.init_ch,
                          max_ch=args.max_ch, output_stride=args.output_stride,
                          is_stride_conv=args.is_stride_conv,
                          is_trans_conv=args.is_trans_conv),
        compute_dtype=args.compute_dtype, num_workers=args.num_workers,
        patient_regex=args.patient_regex,
        save_pred=os.path.join(run_dir, "preds") if args.save_pred else "",
        device=device)


if __name__ == "__main__":
    main()
