"""Checkpoints with the reference's on-disk layout, and resume.

The port of ``pacingpseudo_tpu/train/checkpoint.py``.  Layout (reference
train_chaos.py:405-413, inference.py:279-288):

* interval/final checkpoints:  ``<run_dir>/ckps/ckp_<epoch>``
* best checkpoint:             ``<run_dir>/best_ckp``
* inference resolution order for ``--best_ckp``: ``ckps/best_ckp`` then
  ``best_ckp``; otherwise the final epoch (``ckp_399`` for 400-epoch runs,
  ``ckp_39`` for LVSC).

A checkpoint is a directory of two files:

* ``model.pth``: the model's state_dict on the CPU, in the reference's
  layout (``backbone.*``, ``aux_path.*``, the bank as
  ``aux_path.memory_bank`` ``(C, D, 1, 1)``, BatchNorm running statistics):
  what the reference's ``torch.save(model.state_dict())`` wrote, so
  ``pacingpseudo_tpu/tools/torch_import.py::load_torch_checkpoint`` and the
  reference read it as it stands;
* ``train.pth``: the optimizer's state_dict (Adam's moments and step
  counts) and the train state's ``step``.  It is always written in the
  eager optimizer's layout: Adam's step counts as CPU scalars and
  ``capturable`` False, also when a CUDA graph trained with a capturable
  Adam (``optim.make_capturable``), so any state restores it.

Together they are the full train state, so a run **resumes** exactly.  A
checkpoint is written into a temporary directory beside its path and
renamed into place, so no reader sees a half-written one.

A siamese checkpoint opens in a bare UNet: :func:`restore_params` and
:func:`restore_batch_stats` take the ``backbone.`` entries, as the
reference's prefix-stripping load does (inference.py:138-146).

The Upperbound session's model is the siamese model's class without the
aux path, so its ``model.pth`` has ``backbone.*`` keys and nothing else.
That is the layout of the JAX package's upper-bound state (a
``PacingPseudoModel`` without aux path, ``params['backbone']``), so
``load_torch_checkpoint`` gives back the tree JAX's upper-bound train state
holds, and one state class serves every session's resume.  The reference's
``upper_bound_chaos.py`` saved a bare ``UNet`` (keys without a prefix):
the inference functions open that layout too, and also take the path of
the reference's own ``.pth`` file, a state_dict saved by itself.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Dict, Optional

import torch

from pacingpseudo_torch.train.state import TrainState

MODEL_FILE = "model.pth"
TRAIN_FILE = "train.pth"
_BACKBONE = "backbone."


def save_checkpoint(path: str, state: TrainState) -> None:
    """Save the full train state as the directory ``path`` (replacing it)."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    model_sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    torch.save(model_sd, os.path.join(tmp, MODEL_FILE))
    torch.save({"optimizer": _eager_layout(state.optimizer.state_dict()),
                "step": int(state.step)}, os.path.join(tmp, TRAIN_FILE))
    old = None
    if os.path.exists(path):
        old = f"{path}.old-{os.getpid()}"
        os.replace(path, old)
    os.replace(tmp, path)
    if old is not None:
        shutil.rmtree(old)


def _eager_layout(opt_sd: Dict) -> Dict:
    """An optimizer state_dict with Adam's step counts on the CPU and
    ``capturable`` off (new dicts: the live optimizer is not touched)."""
    state = {i: {k: v.detach().cpu() if k == "step" else v for k, v in s.items()}
             for i, s in opt_sd["state"].items()}
    groups = [dict(g, capturable=False) if "capturable" in g else g
              for g in opt_sd["param_groups"]]
    return {"state": state, "param_groups": groups}


def _model_state(path: str) -> Dict[str, torch.Tensor]:
    """The model state_dict of the checkpoint directory ``path``, or of the
    state_dict file ``path`` (the reference's ``torch.save(model.state_dict())``)."""
    file = path if os.path.isfile(path) else os.path.join(path, MODEL_FILE)
    return torch.load(file, map_location="cpu")


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint of :func:`save_checkpoint` into ``state`` (a state
    of the same configuration, on any device) and return it."""
    state.model.load_state_dict(_model_state(path), strict=True)
    # Read on the CPU: the optimizer moves the moments to their parameters'
    # device and keeps an eager Adam's step counts on the CPU.
    train = torch.load(os.path.join(path, TRAIN_FILE), map_location="cpu")
    state.optimizer.load_state_dict(train["optimizer"])
    state.step = int(train["step"])
    return state


def _pick(saved: Dict[str, torch.Tensor], wanted: Dict[str, torch.Tensor],
          path: str, what: str):
    """``saved``'s entries of the names and shapes of ``wanted``, or of
    ``backbone.<name>`` (a siamese checkpoint opened by a bare UNet)."""
    for prefix in ("", _BACKBONE):
        if all(prefix + n in saved and saved[prefix + n].shape == t.shape
               for n, t in wanted.items()):
            return {n: saved[prefix + n] for n in wanted}
    raise ValueError(f"Checkpoint at {path} does not match the requested model's "
                     f"{what} (neither the full model nor its 'backbone' part).")


@torch.no_grad()
def restore_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load only the parameters of a saved model into ``model`` (inference):
    ``model`` is the saved model's class, or a bare UNet opening a siamese
    checkpoint, whose ``backbone`` parameters are then taken."""
    params = dict(model.named_parameters())
    picked = _pick(_model_state(path), params, path, "parameters")
    for name, p in params.items():
        p.copy_(picked[name])
    return model


@torch.no_grad()
def restore_batch_stats(path: str, model: torch.nn.Module,
                        backbone_only: bool) -> torch.nn.Module:
    """Load the BatchNorm running statistics into ``model``; with
    ``backbone_only`` from the ``backbone`` part of a siamese checkpoint."""
    saved = _model_state(path)
    if backbone_only and any(k.startswith(_BACKBONE) for k in saved):
        saved = {k[len(_BACKBONE):]: v for k, v in saved.items() if k.startswith(_BACKBONE)}
    stats = {n: b for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    picked = _pick(saved, stats, path, "BatchNorm statistics")
    for name, b in stats.items():
        b.copy_(picked[name])
    return model


def saved_is_siamese(path: str) -> bool:
    return any(k.startswith(_BACKBONE) for k in _model_state(path))


def resolve_checkpoint_path(checkpoint_dir: str, dataset: str,
                            best: bool) -> str:
    """Reference checkpoint-path resolution (inference.py:279-288)."""
    if best:
        cand = os.path.join(checkpoint_dir, "ckps", "best_ckp")
        if not os.path.isdir(cand):
            cand = os.path.join(checkpoint_dir, "best_ckp")
        return cand
    final_epoch = 39 if dataset == "lvsc" else 399
    return os.path.join(checkpoint_dir, "ckps", f"ckp_{final_epoch}")


def latest_checkpoint(run_dir: str) -> Optional[str]:
    """Find the newest ``ckps/ckp_<epoch>`` for resume (no reference analogue)."""
    ckps = os.path.join(run_dir, "ckps")
    if not os.path.isdir(ckps):
        return None
    best_epoch, best_path = -1, None
    for name in os.listdir(ckps):
        m = re.fullmatch(r"ckp_(\d+)", name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best_path = os.path.join(ckps, name)
    return best_path
