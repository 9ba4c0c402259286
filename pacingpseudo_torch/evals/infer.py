"""Inference: the forward and Dice on the device, HD95 in host threads.

The port of ``pacingpseudo_tpu/evals/infer.py`` (reference
inference.py:97-194): per-slice, per-class Dice (the hard-label
convention) and HD95 at the dataset's pixel spacing, averaged by
AvgMeters that skip NaN, written to ``eval_data.npz`` as
``(num_slices, num_classes)`` arrays with the slices' ``uids``; the fold
averages exclude the background, and the per-patient aggregation follows
the published protocol.

Slices run in batches of ``batch_size`` (the reference used 1).  Each
batch's image goes up as float16, as the JAX package uploads it
(``infer.py:208-212``): the normalisation then sees the same rounded
values.  The normalisation, the bare UNet's forward and the argmax to
uint8 run on the device.  The predictions come back through two pinned
host buffers without a sync per slice: the copy of batch ``i`` runs while
batch ``i + 1`` is launched, and only then does the host wait for it.
HD95 runs in a thread pool fed in slice order, with at most
``max_backlog`` slices waiting (LVSC has ~29k slices).
"""
from __future__ import annotations

import collections
import concurrent.futures
import logging
import os
import re
import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from pacingpseudo_torch.aug.engine import eval_preprocess_image
from pacingpseudo_torch.config import DATASETS
from pacingpseudo_torch.data.npz_dataset import BatchLoader, SliceDataset
from pacingpseudo_torch.data.splits import read_test_split
from pacingpseudo_torch.evals.dice import compute_dice_hard
from pacingpseudo_torch.evals.hd import compute_95hd
from pacingpseudo_torch.models.unet import UNet
from pacingpseudo_torch.train.checkpoint import (restore_batch_stats, restore_params,
                                                 saved_is_siamese)
from pacingpseudo_torch.utils import AvgMeter


def patient_key(uid: str, patient_regex: str = "") -> str:
    """The patient of a slice uid, for the published per-patient aggregation
    (reference README.md:106): the first capture group of ``patient_regex``
    where it matches, else the uid's first ``_``-separated token (chaos
    ``<pat>_<sl>``, acdc ``patientXXX_frame_slice``, lvsc ``<id>_...``); a
    uid without a separator is its own patient."""
    if patient_regex:
        m = re.match(patient_regex, uid)
        if m and m.groups():
            return m.group(1)
    return uid.split("_")[0]


def aggregate_per_patient(uids, arr: np.ndarray, num_classes: int,
                          patient_regex: str = "") -> Dict[str, object]:
    """Per class, the NaN-skipping mean of each patient's slices, then the
    mean over patients; ``overall`` averages classes 1..C-1 (README.md:106,
    inference.py:185-192)."""
    groups: Dict[str, List[int]] = {}
    for i, uid in enumerate(uids):
        groups.setdefault(patient_key(str(uid), patient_regex), []).append(i)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slices
        per_patient = {pat: np.nanmean(arr[idx], axis=0) for pat, idx in groups.items()}
        class_means = np.nanmean(np.stack(list(per_patient.values())), axis=0)
        overall = float(np.nanmean(class_means[1:num_classes]))
    return {"overall": overall,
            "class_means": [float(x) for x in class_means],
            "num_patients": len(groups)}


def load_inference_model(checkpoint_path: str, num_classes: int,
                         model_kwargs: Dict = None, compute_dtype: str = "bfloat16",
                         device="cuda") -> UNet:
    """The bare UNet (reference inference.py:104-113) in eval mode on
    ``device``, with the parameters and BatchNorm statistics of a checkpoint
    of any session: a siamese one gives its backbone (inference.py:138-146)."""
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]
    model = UNet(num_classes=num_classes, elab_end_points=False, dtype=dtype,
                 device=device, **(model_kwargs or {}))
    restore_params(checkpoint_path, model)
    restore_batch_stats(checkpoint_path, model, saved_is_siamese(checkpoint_path))
    return model.eval()


@torch.no_grad()
def forward_hard(model: UNet, image_f16: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Hard predictions ``(N, S, S)`` uint8 of float16 canvases ``(N, S, S)``
    with live extents ``size`` (N, 2), on their device."""
    logits = model(eval_preprocess_image(image_f16, size))["segmentation/logits"]
    return logits.argmax(dim=1).to(torch.uint8)


def run_inference(dataset: str, fold: int, checkpoint_path: str,
                  data_root: str, run_dir: str, batch_size: int = 8,
                  model_kwargs: Dict = None, compute_dtype: str = "bfloat16",
                  num_workers: int = 4, patient_regex: str = "",
                  max_backlog: int = 4096, save_pred: str = "",
                  device="cuda"):
    """See the module docstring.  ``save_pred``: a directory to which each
    slice's hard prediction (uint8, cropped to its extent) goes as
    ``<uid>.npz`` (key ``pred``) as it arrives.  ``device`` defaults to the
    card; the CPU runs only when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {device}: pass the CPU explicitly")
    spec = DATASETS[dataset]
    num_classes, spacing = spec.num_classes, spec.spacing
    logging.info("Number of classes: %d", num_classes)
    logging.info("Spacing: %s", (spacing,))
    model = load_inference_model(checkpoint_path, num_classes, model_kwargs,
                                 compute_dtype, device)

    ds = SliceDataset(read_test_split(data_root, dataset, fold), num_classes,
                      spec.ignored_index)
    loader = BatchLoader(ds, batch_size, shuffle=False, drop_last=False,
                         num_threads=num_workers)
    logging.info("Length %d", len(loader))

    dicearr: List[List[float]] = []
    hd95arr: List[List[float]] = []
    uids: List[str] = []
    meter_dice = [AvgMeter() for _ in range(num_classes)]
    meter_hd95 = [AvgMeter() for _ in range(num_classes)]
    if save_pred:
        os.makedirs(save_pred, exist_ok=True)

    def host_metrics(pred, label, h, w, uid):
        p = pred[:h, :w]
        lab = label[:h, :w].astype(np.int64)
        if save_pred:
            np.savez_compressed(os.path.join(save_pred, f"{uid}.npz"),
                                uid=uid, pred=p.astype(np.uint8))
        return (compute_dice_hard(p, lab, num_classes),
                compute_95hd(p, lab, num_classes, spacing))

    def collect(fut):
        dicelog, hd95log = fut.result()
        dicearr.append(dicelog)
        hd95arr.append(hd95log)
        for cls in range(num_classes):
            if not np.isnan(dicelog[cls]):
                meter_dice[cls].update(dicelog[cls])
            if not np.isnan(hd95log[cls]):
                meter_hd95[cls].update(hd95log[cls])

    # Two pinned host buffers, used in turn: batch i's copy fills one while
    # batch i - 1's predictions are read out of the other.
    cs = ds.canvas_size
    on_card = device.type == "cuda"
    buffers = [torch.empty((batch_size, cs, cs), dtype=torch.uint8, pin_memory=on_card)
               for _ in range(2)]

    tic = time.time()
    n_slices = 0
    with concurrent.futures.ThreadPoolExecutor(max(num_workers, 1)) as pool:
        pending = collections.deque()
        in_flight = []

        def drain(entry):
            nonlocal n_slices
            host, done, raw = entry
            if done is not None:
                done.synchronize()
            preds = host.numpy().copy()     # the buffer is refilled next
            for i in range(preds.shape[0]):
                h, w = int(raw["size"][i][0]), int(raw["size"][i][1])
                uid = str(raw["uid"][i])
                pending.append(pool.submit(host_metrics, preds[i], raw["label"][i],
                                           h, w, uid))
                uids.append(uid)
                n_slices += 1
            while pending and pending[0].done():
                collect(pending.popleft())
            while len(pending) > max_backlog:
                collect(pending.popleft())

        for b, raw in enumerate(loader):
            image = torch.from_numpy(raw["image"].astype(np.float16)).to(device)
            size = torch.from_numpy(raw["size"]).to(device)
            preds = forward_hard(model, image, size)
            host = buffers[b % 2][:preds.shape[0]]
            host.copy_(preds, non_blocking=on_card)
            done = None
            if on_card:
                done = torch.cuda.Event()
                done.record()
            in_flight.append((host, done, raw))
            if len(in_flight) > 1:
                drain(in_flight.pop(0))
        while in_flight:
            drain(in_flight.pop(0))
        while pending:
            collect(pending.popleft())
    toc = time.time()

    dicearr_np = np.asarray(dicearr, np.float32)
    hd95arr_np = np.asarray(hd95arr, np.float32)
    np.savez(os.path.join(run_dir, "eval_data"), dicearr=dicearr_np, hd95arr=hd95arr_np,
             uids=np.asarray(uids))

    foldavgdice = float(np.mean([meter_dice[c].avg for c in range(1, num_classes)]))
    foldavghd95 = float(np.mean([meter_hd95[c].avg for c in range(1, num_classes)]))
    pat_dice = aggregate_per_patient(uids, dicearr_np, num_classes, patient_regex)
    pat_hd95 = aggregate_per_patient(uids, hd95arr_np, num_classes, patient_regex)
    slices_per_sec = n_slices / max(toc - tic, 1e-9)
    logging.info("Dataset: %s", dataset)
    logging.info("Number of classes: %d", num_classes)
    logging.info("Fold %d, overall Dice: %.4f, overall HD95: %.2f",
                 fold, foldavgdice, foldavghd95)
    logging.info("Per-patient (%d patients) Dice: %.4f, HD95: %.2f "
                 "(README.md:106 protocol)", pat_dice["num_patients"],
                 pat_dice["overall"], pat_hd95["overall"])
    logging.info("Shape of the Dice array: %s", dicearr_np.shape)
    logging.info("Shape of the HD95 array: %s", hd95arr_np.shape)
    logging.info("%d slices in %.1fs (%.1f slices/s)", n_slices, toc - tic, slices_per_sec)
    return {"dice": foldavgdice, "hd95": foldavghd95,
            "dice_per_patient": pat_dice["overall"],
            "hd95_per_patient": pat_hd95["overall"],
            "num_patients": pat_dice["num_patients"],
            "dicearr": dicearr_np, "hd95arr": hd95arr_np, "uids": uids,
            "slices_per_sec": slices_per_sec}
