"""Port parity: a fresh initialisation of the port's Experiment model against
JAX's ``model.init``, leaf by leaf, on the CPU.

The two draws come from different generators (JAX's keys folded by scope
path, the port's ``torch.Generator`` in module order), so the leaves are
held in distribution, not value: JAX's draw through ``tests/jax_init.py``
(``create_train_state`` as its loop calls it, ``model.init`` compiled at
XLA's lowest backend optimisation), carried into the port's names by
``pacingpseudo_torch.tools.weights.from_jax_variables``; the port's by
``train.state.create_train_state`` (``torch_default_init_``), both at seed
1, 64x64, init_ch 8, hid_ch 16, the Experiment model with its aux path and
bank.  JAX's model takes ``s2d_hires=False``: its space-to-depth convs
declare the same parameters, drawn the same.

* the same leaves, of the same shapes;
* where JAX's leaf is all zeros the port's is all zeros (the convs'
  biases are drawn, the aux bottleneck's is Flax's default zero bias);
* a conv leaf is uniform on +-1/sqrt(fan_in) on both sides (fan_in the
  weight's in-channels times its taps; a transposed conv's out-channels):
  no element beyond the bound, and for a leaf of at least ``LARGE``
  elements the largest |w| at least ``0.9`` of it (a uniform draw of
  ``LARGE`` elements stays below 0.9 of its bound with odds 0.9**256 ~
  2e-12) and the mean |w| within ``MEAN_BAND`` of half of it;
* BatchNorm's scale, shift and statistics, and the bank, equal exactly.
"""
import sys

import numpy as np
import pytest
import torch

from pacingpseudo_tpu.config import ExperimentConfig as JaxConfig
from pacingpseudo_torch.config import ExperimentConfig
from pacingpseudo_torch.tools.weights import from_jax_variables
from pacingpseudo_torch.train.state import create_train_state

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import jax_init  # noqa: E402

CONFIG = dict(seed=1, dataset="chaost1", session="Experiment", num_classes=5, ignored_index=5,
              do_loss_ent=True, do_decoder_consistency=True, do_aux_path=True, do_memory=True,
              init_ch=8, hid_ch=16, input_size=(64, 64), compute_dtype="float32")
LARGE, MEAN_BAND = 256, 0.05
BN = ("running_mean", "running_var", "num_batches_tracked")


@pytest.fixture(scope="module")
def inits():
    """The converted JAX draw and the port's fresh state_dict."""
    params, stats, bank = jax_init.draw(JaxConfig(**CONFIG, s2d_hires=False), batch=1,
                                        size=64)
    want = from_jax_variables(params, stats, bank)
    model = create_train_state(ExperimentConfig(**CONFIG).validate(), device="cpu").model
    return want, model


def _is_bn(model, key):
    module = model.get_submodule(key.rsplit(".", 1)[0])
    return not isinstance(module, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))


def _bound(model, key):
    """1/sqrt(fan_in) of the conv that holds ``key``."""
    conv = model.get_submodule(key.rsplit(".", 1)[0])
    return (conv.weight.shape[1] * conv.weight[0, 0].numel()) ** -0.5


def test_the_same_leaves(inits):
    want, model = inits
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape for k in want)
    assert len(want) > 100 and "aux_path.memory_bank" in want


def test_zero_where_jax_is_zero(inits):
    """The aux bottleneck's bias is one such leaf: Flax's default zero bias
    (the port drew it from the conv default before)."""
    want, model = inits
    got = model.state_dict()
    zero = [k for k, v in want.items() if v.dtype.is_floating_point and not v.any()]
    assert "aux_path.layer_bottleneck.1.bias" in zero
    assert [k for k in zero if got[k].any()] == []


def test_conv_leaves_share_the_bound(inits):
    want, model = inits
    got = model.state_dict()
    conv = [k for k in want if not _is_bn(model, k) and k != "aux_path.memory_bank"
            and want[k].any()]
    assert len(conv) > 40
    for key in conv:
        bound = _bound(model, key)
        for side, v in (("jax", want[key]), ("port", got[key])):
            a = v.abs().double()
            assert float(a.max()) <= bound * (1 + 1e-6), (side, key, float(a.max()), bound)
            if v.numel() >= LARGE:
                assert float(a.max()) >= 0.9 * bound, (side, key, float(a.max()), bound)
                assert abs(float(a.mean()) / bound - 0.5) <= MEAN_BAND, (side, key)


def test_batch_norm_and_bank_match(inits):
    want, model = inits
    got = model.state_dict()
    keys = [k for k in want if _is_bn(model, k) or k.endswith(BN)]
    assert "aux_path.memory_bank" in keys and len(keys) > 80
    for key in keys:
        assert torch.equal(got[key], want[key].to(got[key].dtype)), key
