"""Weight bridge: JAX ``PacingPseudoModel`` / ``UNet`` variables -> state_dict.

The port's own copy of ``pacingpseudo_tpu/tools/torch_import.py``'s
``export_state_dict`` (:144-209).  It takes the variables as nested dicts
of numpy arrays, so it needs neither JAX nor the JAX package, and returns
a state_dict that loads into the port's model with
``load_state_dict(strict=True)``.  The keys are the reference's:

* ``...conv_layerJ.norm`` -> ``norm_op``;
* ``aux_path.conv_bottleneck`` -> ``aux_path.layer_bottleneck.1``,
  ``aux_path.norm_bottleneck`` -> ``aux_path.layer_bottleneck.2``,
  ``aux_path.fc_cls`` -> ``aux_path.fc_cls.1``;
* the bank -> ``aux_path.memory_bank`` ``(C, D, 1, 1)``.

Layouts: flax conv kernels ``(kh, kw, in, out)`` become torch
``(out, in, kh, kw)``; a flax ``ConvTranspose(transpose_kernel=True)``
kernel ``(kh, kw, out, in)`` becomes torch ConvTranspose2d's
``(in, out, kh, kw)`` by the same transpose (torch_import.py:41-46);
running mean/var go to the BN buffers, with ``num_batches_tracked`` 0.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _module_name(mod: Tuple[str, ...]) -> str:
    if mod and mod[0] == "aux_path":
        sub = {"conv_bottleneck": "layer_bottleneck.1",
               "norm_bottleneck": "layer_bottleneck.2",
               "fc_cls": "fc_cls.1"}[mod[1]]
        return "aux_path." + sub
    return ".".join("norm_op" if m == "norm" else m for m in mod)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def from_jax_variables(params: Dict, batch_stats: Dict,
                       memory_bank: Optional[np.ndarray] = None
                       ) -> Dict[str, torch.Tensor]:
    """State_dict of the port's model from JAX ``params``/``batch_stats``.

    Pass the trees of a ``PacingPseudoModel`` (rooted at ``backbone`` and
    ``aux_path``) or of a bare ``UNet``.  With an aux path and no
    ``memory_bank``, the bank is all zeros (a fresh bank).
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, mod):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                walk(v, mod + (k,))
                continue
            name = _module_name(mod)
            if k == "kernel":
                out[name + ".weight"] = _tensor(
                    np.transpose(np.asarray(v, np.float32), (3, 2, 0, 1)))
            elif k == "scale":
                out[name + ".weight"] = _tensor(v)
            elif k == "bias":
                out[name + ".bias"] = _tensor(v)
            else:
                raise KeyError(f"Unmapped param leaf: {mod + (k,)}")

    def walk_stats(tree, mod):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                walk_stats(v, mod + (k,))
                continue
            name = _module_name(mod)
            if k == "mean":
                out[name + ".running_mean"] = _tensor(v)
                out[name + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long)
            elif k == "var":
                out[name + ".running_var"] = _tensor(v)
            else:
                raise KeyError(f"Unmapped batch_stats leaf: {mod + (k,)}")

    walk(params, ())
    walk_stats(batch_stats, ())
    if "aux_path" in params:
        if memory_bank is None:
            _, _, hid_ch, num_classes = np.shape(params["aux_path"]["fc_cls"]["kernel"])
            memory_bank = np.zeros((num_classes, hid_ch), np.float32)
        out["aux_path.memory_bank"] = _tensor(memory_bank)[:, :, None, None].contiguous()
    return out
