"""Port checkpoints (``pacingpseudo_torch/train/checkpoint.py``) against
the JAX package's conventions (CPU, float32, 64x64, init_ch 8, batch 2).

* A save/restore round trip gives back the state bit for bit: parameters,
  BatchNorm statistics, the bank, Adam's moments and step counts, and the
  train state's ``step``; a step taken after the restore equals the step
  the saved run takes next, bit for bit.
* The model file is what the JAX package's importer reads as it stands
  (``tools/torch_import.py::load_torch_checkpoint``): the JAX model with
  the weights it returns gives the port's eval forward within 1e-4 x the
  logits' max |value| (float32 convolutions in another order, as
  ``test_torch_port_model.py`` holds them).
* ``restore_params`` / ``restore_batch_stats(backbone_only=True)`` open a
  siamese checkpoint in a bare UNet (exact copies), and refuse a model of
  other widths.
* ``latest_checkpoint`` and ``resolve_checkpoint_path`` give the JAX
  package's paths on the same trees of directories.

The train state is made by two port train steps on a numpy batch.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacingpseudo_tpu.models import PacingPseudoModel as JaxPacing
from pacingpseudo_tpu.tools.torch_import import load_torch_checkpoint
from pacingpseudo_tpu.train import checkpoint as jax_ckpt
from pacingpseudo_torch.config import ExperimentConfig
from pacingpseudo_torch.models import UNet
from pacingpseudo_torch.train import checkpoint as ckpt
from pacingpseudo_torch.train.state import TrainState, create_train_state
from pacingpseudo_torch.train.step import make_pacing_train_step

N, S, C, INIT_CH, HID = 2, 64, 4, 8, 16
FLAGS = dict(num_classes=C, ignored_index=C, init_ch=INIT_CH, hid_ch=HID,
             batch_size=N, session="Experiment", do_loss_ent=True,
             do_decoder_consistency=True, do_aux_path=True, do_memory=True,
             compute_dtype="float32")


def _batch(seed):
    """A pre-augmented NCHW batch from numpy: image and strong image, a
    sparse scribble one-hot over C+1 (the last channel is ignore), labels,
    a valid mask."""
    rs = np.random.RandomState(seed)
    image = rs.randn(N, 1, S, S).astype(np.float32)
    strong = (1.2 * image + 0.1 * rs.randn(N, 1, S, S)).astype(np.float32)
    scb = np.full((N, S, S), C)
    pick = rs.rand(N, S, S) < 0.1
    scb[pick] = rs.randint(0, C, pick.sum())
    label = rs.randint(0, C, (N, S, S))
    eye = np.eye(C + 1, dtype=np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in {
        "image": image, "image_strong": strong,
        "scribble": np.moveaxis(eye[scb], -1, 1),
        "label": np.moveaxis(eye[label][..., :C], -1, 1),
        "valid_mask": (rs.rand(N, 1, S, S) > 0.2).astype(np.float32)}.items()}


def _config():
    return ExperimentConfig(**FLAGS).validate()


def _trained_state(seed=5, steps=2):
    config = _config()
    state = create_train_state(config, device="cpu", seed=seed)
    step = make_pacing_train_step(config, steps_per_epoch=1)
    for i in range(steps):
        step(state, _batch(i))
    return state


def _optimizer_tensors(state):
    out = {}
    for name, p in state.model.named_parameters():
        for k, v in state.optimizer.state[p].items():
            out[f"{name}.{k}"] = v
    return out


def _assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = _optimizer_tensors(a), _optimizer_tensors(b)
    # exp_avg, exp_avg_sq and step of every parameter
    assert sorted(oa) == sorted(ob) and len(oa) == 3 * len(list(a.model.parameters()))
    for k in oa:
        assert torch.equal(oa[k], ob[k]), k
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"]


@pytest.fixture
def one_thread():
    """Bit-for-bit comparisons of two runs go single-threaded: MKL picks its
    thread count by the machine's load, and with it a reduction's order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_round_trip_is_bit_exact_and_resumes_the_same_step(tmp_path, one_thread):
    state = _trained_state()
    path = str(tmp_path / "ckps" / "ckp_1")
    ckpt.save_checkpoint(path, state)
    assert sorted(os.listdir(path)) == [ckpt.MODEL_FILE, ckpt.TRAIN_FILE]
    ckpt.save_checkpoint(path, state)              # replaces, leaves no temporaries
    assert os.listdir(tmp_path / "ckps") == ["ckp_1"]

    restored = ckpt.restore_checkpoint(path, create_train_state(_config(), device="cpu", seed=9))
    assert restored.step == 2 and float(restored.memory_bank.abs().sum()) > 0
    _assert_states_equal(state, restored)

    step = make_pacing_train_step(_config(), steps_per_epoch=1)
    m1, m2 = step(state, _batch(7)), step(restored, _batch(7))
    assert all(torch.equal(torch.as_tensor(m1[k]), torch.as_tensor(m2[k])) for k in m1)
    _assert_states_equal(state, restored)


def test_jax_importer_reads_the_model_file_and_reproduces_the_forward(tmp_path):
    state = _trained_state()
    path = str(tmp_path / "best_ckp")
    ckpt.save_checkpoint(path, state)
    params, stats, bank = load_torch_checkpoint(os.path.join(path, ckpt.MODEL_FILE))
    np.testing.assert_array_equal(bank, state.memory_bank.numpy())

    image = _batch(11)["image"]
    model = state.model.eval()
    with torch.no_grad():
        want = model(image, None, train=False)["segmentation/logits"]
    jax_model = JaxPacing(num_classes=C, init_ch=INIT_CH, do_aux_path=True,
                          hid_ch=HID, s2d_hires=False, dtype=jnp.float32)
    out = jax_model.apply({"params": params, "batch_stats": stats},
                          np.moveaxis(image.numpy(), 1, -1), None, train=False)
    got = torch.from_numpy(np.moveaxis(np.asarray(out["segmentation/logits"]), -1, 1).copy())
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


def test_bare_unet_opens_a_siamese_checkpoint(tmp_path):
    state = _trained_state()
    path = str(tmp_path / "ckp")
    ckpt.save_checkpoint(path, state)
    assert ckpt.saved_is_siamese(path)

    unet = UNet(num_classes=C, init_ch=INIT_CH, output_stride=8, device="cpu")
    ckpt.restore_params(path, unet)
    ckpt.restore_batch_stats(path, unet, backbone_only=True)
    want = state.model.backbone.state_dict()
    got = unet.state_dict()
    for k, v in got.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k

    bare_path = str(tmp_path / "bare")
    ckpt.save_checkpoint(bare_path, TrainState(unet, torch.optim.Adam(unet.parameters())))
    assert not ckpt.saved_is_siamese(bare_path)
    with pytest.raises(ValueError):
        ckpt.restore_params(path, UNet(num_classes=C, init_ch=2 * INIT_CH, output_stride=8,
                                       device="cpu"))


TREES = {
    "empty": [],
    "no ckps": ["best_ckp/"],
    "ckps, no epochs": ["ckps/"],
    "epochs": ["ckps/ckp_0/", "ckps/ckp_9/", "ckps/ckp_10/", "ckps/ckp_2/"],
    "with temporaries": ["ckps/ckp_3/", "ckps/ckp_12.tmp-7/", "ckps/best_ckp/",
                         "ckps/ckp_x/", "ckps/notes.txt"],
    "best in ckps": ["ckps/best_ckp/", "best_ckp/", "ckps/ckp_399/"],
    "best at root": ["best_ckp/", "ckps/ckp_39/"],
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_paths_match_jax(tmp_path, tree):
    for rel in TREES[tree]:
        p = tmp_path / rel
        if rel.endswith("/"):
            p.mkdir(parents=True, exist_ok=True)
        else:
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text("")
    run_dir = str(tmp_path)
    assert ckpt.latest_checkpoint(run_dir) == jax_ckpt.latest_checkpoint(run_dir)
    for dataset in ("chaos", "lvsc"):
        for best in (True, False):
            assert (ckpt.resolve_checkpoint_path(run_dir, dataset, best)
                    == jax_ckpt.resolve_checkpoint_path(run_dir, dataset, best))
