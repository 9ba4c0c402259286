"""Port parity: ``pacingpseudo_torch.aug.engine`` against
``pacingpseudo_tpu.aug.engine`` (CPU, float32, crop 64, canvas 64-96).

PyTorch cannot reproduce JAX's threefry draws, so the port's engine has a
draw layer and an apply layer, and these tests hold them apart:

* **apply**: the test re-derives the JAX engine's draws itself, from the
  same key splits and with the engine's own ``_bern``/``_uniform``
  (``pacingpseudo_tpu/aug/engine.py:151-215,246-251,289-290`` and
  ``:321-389``), hands those values to the port's apply layer, and compares
  with ``base_augment_sample`` / ``strong_augment_sample`` /
  ``augment_batch``.
  Tolerances.  Base pipeline: the two sides form the same coordinates up
  to float32 rounding (``cos``/``sin``, and the elastic field's upsample,
  which is ``F.interpolate`` here and two matrix products there, times an
  amplitude of up to 25), so a coordinate may differ by ~1e-5 px; where it
  straddles an integer a class vote or a cubic tap flips.  So: image
  within 1e-3 on at least 99.9% of the pixels, label and scribble
  different on at most 0.1% of the pixels, ``valid_mask`` equal.  Worst
  measured over the cases below: 0 pixels of image beyond 1e-3 (largest
  difference 3.4e-5), 0 label or scribble pixels different.  Strong
  stream: 1e-4 x max.
* **draw**: 20,000 draws; each gate's rate and each range's mean within 4
  standard errors of the parameters, the extremes inside the range and
  within 10/n of its ends; seeded draws repeat; samples differ.
* **the whole engine, statistically**: the port's ``augment_batch`` from
  its own generator against the JAX engine from its own key, on
  ``aug_parity.gen_samples``, at the thresholds of
  ``tests/test_aug_parity.py``: image KS < 0.10, gradient KS < 0.17, strong
  KS < 0.10, foreground area within 10%, ignored share within 0.03, valid
  coverage within 0.04.
* ``eval_preprocess_batch`` / ``eval_preprocess_image``: 1e-5,
  ``region_mask`` exact.
* The train step with an ``augment_fn`` equals ``augment_batch`` followed
  by the step without one: the same metrics and gradients, exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacingpseudo_tpu.aug import engine as jax_engine
from pacingpseudo_tpu.aug.params import BaseAugParams as JaxBase
from pacingpseudo_tpu.aug.params import StrongAugParams as JaxStrong
from pacingpseudo_tpu.tools import aug_parity
from pacingpseudo_torch.aug import engine
from pacingpseudo_torch.aug.params import BaseAugParams, StrongAugParams
from pacingpseudo_torch.aug.presets import PRESETS, base_params_for, strong_params_for
from pacingpseudo_torch.config import ExperimentConfig
from pacingpseudo_torch.train.state import create_train_state
from pacingpseudo_torch.train.step import make_pacing_train_step

C = 4            # classes; C is the ignored index
CROP = (64, 64)
OFF = dict(p_scale=0.0, p_elastic=0.0, p_rotate=0.0, p_mirror_y=0.0,
           p_mirror_x=0.0, p_noise=0.0)
ON = dict(p_scale=1.0, p_elastic=1.0, p_rotate=1.0, p_mirror_y=0.5,
          p_mirror_x=0.5, p_noise=1.0)


def _both(cls_a, cls_b, **kw):
    """The same parameter bundle for the JAX package and for the port."""
    return cls_a(**kw), cls_b(**kw)


def _base_params(**kw):
    kw = dict(crop_size=CROP, num_classes=C, ignored_index=C, **kw)
    return _both(JaxBase, BaseAugParams, **kw)


def _raw(seed, sizes, canvas):
    """A raw canvas batch as numpy: smooth image, blocky labels, sparse
    scribbles, padded with 0 / the ignored index beyond each live size."""
    rs = np.random.RandomState(seed)
    n = len(sizes)
    yy, xx = np.mgrid[0:canvas, 0:canvas]
    image = np.zeros((n, canvas, canvas), np.float32)
    label = np.full((n, canvas, canvas), C, np.float32)
    scribble = np.full((n, canvas, canvas), C, np.float32)
    for i, (h, w) in enumerate(sizes):
        img = (np.sin(yy / rs.uniform(3, 9)) * np.cos(xx / rs.uniform(3, 9))
               + 0.3 * rs.randn(canvas, canvas))
        lab = ((yy // 11 + xx // 13 + i) % C).astype(np.float32)
        scb = np.where(rs.rand(canvas, canvas) < 0.15, lab, C)
        image[i, :h, :w] = img[:h, :w]
        label[i, :h, :w] = lab[:h, :w]
        scribble[i, :h, :w] = scb[:h, :w]
    return {"image": image, "label": label, "scribble": scribble,
            "size": np.asarray(sizes, np.int32)}


def _torch_raw(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def _stack(dicts):
    """Per-sample dicts of jax values -> one dict of batched torch tensors."""
    return {k: torch.from_numpy(np.stack([np.asarray(d[k]) for d in dicts]))
            for k in dicts[0]}


# ---------------------------------------------------------------------------
# The JAX engine's draws, re-derived
# ---------------------------------------------------------------------------

def jax_base_draws(key, p):
    """``base_augment_sample``'s random values for one sample
    (engine.py:151-215, 246-251, 289-290), under the port's names."""
    bern, uni = jax_engine._bern, jax_engine._uniform
    ch, cw = p.crop_size
    keys = jax.random.split(key, 18)
    if p.p_rot90 > 0:
        choices = jnp.asarray(p.rot90_choices, jnp.int32)
        pick = jax.random.randint(keys[17], (), 0, len(p.rot90_choices))
        k90 = jnp.where(bern(keys[16], p.p_rot90), choices[pick], 0)
    else:
        k90 = jnp.int32(0)
    do_el = bern(keys[2], p.p_elastic)
    fh, fw = max(ch // p.elastic_field_downscale, 2), max(
        cw // p.elastic_field_downscale, 2)
    return {
        "k90": k90,
        "scale": jnp.where(bern(keys[0], p.p_scale),
                           uni(keys[1], *p.scale_range), 1.0),
        "sigma": uni(keys[3], *p.sigma_range),
        "alpha": jnp.where(do_el, uni(keys[4], *p.alpha_range), 0.0),
        "theta": jnp.where(bern(keys[5], p.p_rotate),
                           uni(keys[6], *p.degree_range) * (jnp.pi / 180.0), 0.0),
        "flip_y": bern(keys[7], p.p_mirror_y),
        "flip_x": bern(keys[8], p.p_mirror_x),
        "noise_scale": jnp.where(bern(keys[9], p.p_noise),
                                 uni(keys[10], *p.noise_scale_range), 0.0),
        "crop_u": jnp.stack([jax.random.uniform(keys[k]) for k in (11, 12, 13, 14)]),
        "elastic_noise": jnp.stack([
            jax.random.uniform(keys[15], (fh, fw)),
            jax.random.uniform(jax.random.fold_in(keys[15], 1), (fh, fw))]),
        "noise": jax.random.normal(jax.random.fold_in(keys[15], 2), (ch, cw)),
    }


def jax_strong_draws(key, p, height, width):
    """``strong_augment_sample``'s random values for one sample
    (engine.py:321-389), under the port's names."""
    bern, uni = jax_engine._bern, jax_engine._uniform
    keys = jax.random.split(key, 16)
    lo, hi = p.gamma_range
    do_g = bern(keys[4], p.p_gamma)
    pick_low = (jax.random.uniform(keys[5]) < 0.5) & (lo < 1.0)
    gamma = jnp.where(pick_low, uni(keys[6], lo, 1.0),
                      uni(keys[6], max(1.0, lo), hi))
    out = {
        "brightness": jnp.where(bern(keys[0], p.p_brightness),
                                uni(keys[1], *p.brightness_range), 0.0),
        "contrast": jnp.where(bern(keys[2], p.p_contrast),
                              uni(keys[3], *p.contrast_range), 1.0),
        "do_gamma": do_g, "gamma": jnp.where(do_g, gamma, 1.0),
    }
    if p.p_blur > 0:
        out["do_blur"] = bern(keys[7], p.p_blur)
        out["blur_sigma"] = uni(keys[8], *p.blur_sigma_range)
    if p.p_mixup > 0:
        out["lam"] = jnp.where(bern(keys[9], p.p_mixup),
                               uni(keys[10], *p.mixup_lam_range), 1.0)
    if p.p_lowres > 0:
        out["do_lowres"] = bern(keys[11], p.p_lowres)
        out["lowres_scale"] = uni(keys[12], *p.lowres_scale_range)
    if p.p_cutout > 0:
        out["do_cutout"] = bern(keys[13], p.p_cutout)
        out["cut_y"] = jax.random.randint(keys[14], (), 0, height)
        out["cut_x"] = jax.random.randint(keys[15], (), 0, width)
    return out


@functools.lru_cache(maxsize=None)
def _jax_base_fn(p):
    return jax.jit(functools.partial(jax_engine.base_augment_sample, p=p))


def _assert_base_close(got, want, what):
    """The base pipeline's tolerance (module docstring).  ``got`` holds the
    port's (N, H, W) tensors, ``want`` a list of the JAX per-sample dicts."""
    wanted = {k: np.stack([np.asarray(w[k]) for w in want]) for k in want[0]}
    np.testing.assert_array_equal(got["valid_mask"].numpy(),
                                  wanted["valid_mask"], err_msg=what)
    far = np.abs(got["image"].numpy() - wanted["image"]) > 1e-3
    assert far.mean() <= 1e-3, (what, "image", far.mean())
    for k in ("label", "scribble"):
        diff = got[k].numpy() != wanted[k]
        assert diff.mean() <= 1e-3, (what, k, diff.mean())


# ---------------------------------------------------------------------------
# apply, base
# ---------------------------------------------------------------------------

SQUARE = [(64, 64), (64, 64), (64, 64)]
BASE_CASES = {
    # name: (params, live sizes, canvas)
    "identity_crop": (OFF, SQUARE, 64),
    "embed": (OFF, [(48, 40), (64, 50), (33, 64)], 64),
    "crop": (OFF, [(90, 80), (96, 96), (70, 95)], 96),
    "mirror": ({**OFF, "p_mirror_y": 1.0, "p_mirror_x": 1.0}, SQUARE, 64),
    "rotation": ({**OFF, "p_rotate": 1.0}, [(64, 64), (80, 72), (50, 60)], 96),
    "scaling": ({**OFF, "p_scale": 1.0}, [(64, 64), (90, 80), (48, 56)], 96),
    "elastic": ({**OFF, "p_elastic": 1.0}, [(64, 64), (80, 72), (56, 64)], 96),
    "rot90_rectangular": ({**OFF, "p_rot90": 1.0},
                          [(48, 80), (90, 60), (64, 40), (40, 64)], 96),
    "all_bilinear": ({**ON, "image_interp": "bilinear"},
                     [(64, 64), (90, 80), (48, 56)], 96),
    "all_bicubic": ({**ON, "p_rot90": 0.5}, [(64, 64), (90, 80), (48, 56)], 96),
    "all_bicubic_bf16_table": ({**ON, "warp_table_dtype": "bf16"},
                               [(64, 64), (90, 80), (48, 56)], 96),
}


@pytest.mark.parametrize("case", list(BASE_CASES))
def test_apply_base_from_mirrored_draws(case):
    overrides, sizes, canvas = BASE_CASES[case]
    jp, tp = _base_params(**overrides)
    raw = _raw(11, sizes, canvas)
    keys = jax.random.split(jax.random.PRNGKey(len(case)), len(sizes))
    draws = [jax_base_draws(k, jp) for k in keys]
    want = [_jax_base_fn(jp)(*(jnp.asarray(raw[f][i]) for f in
                               ("image", "label", "scribble", "size")), keys[i])
            for i in range(len(sizes))]
    got = engine.apply_base(_torch_raw(raw), _stack(draws), tp)
    assert got["image"].dtype == torch.float32
    assert got["label"].dtype == torch.int32 and got["scribble"].dtype == torch.int32
    _assert_base_close(got, want, case)
    if case == "identity_crop":     # every pixel visible, labels untouched
        assert bool((got["valid_mask"] == 1).all())
        np.testing.assert_array_equal(got["label"].numpy(), raw["label"])
    if case == "rot90_rectangular":
        assert {int(d["k90"]) for d in draws} <= {1, 2, 3}


# ---------------------------------------------------------------------------
# apply, strong
# ---------------------------------------------------------------------------

STRONG_CASES = {
    "color": {},
    "color_inverted_gamma": dict(gamma_invert=True, gamma_retain_stats=False),
    "blur": dict(p_blur=1.0),
    "mixup": dict(p_mixup=1.0),
    "lowres": dict(p_lowres=1.0),
    "cutout": dict(p_cutout=1.0, cutout_length=16),
    "everything": dict(p_blur=0.5, p_mixup=0.5, p_lowres=0.5, p_cutout=0.5),
}


@pytest.mark.parametrize("case", list(STRONG_CASES))
def test_apply_strong_from_mirrored_draws(case):
    """1e-4 x max against ``strong_augment_sample``."""
    jp, tp = _both(JaxStrong, StrongAugParams, **STRONG_CASES[case])
    n, (h, w) = 4, (48, 64)
    rs = np.random.RandomState(12)
    image = rs.randn(n, h, w).astype(np.float32)
    partner = rs.randn(n, h, w).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(100 + len(case)), n)
    fn = jax.jit(functools.partial(jax_engine.strong_augment_sample, p=jp))
    want = np.stack([np.asarray(fn(jnp.asarray(image[i]), jnp.asarray(partner[i]),
                                   keys[i])) for i in range(n)])
    draws = _stack([jax_strong_draws(k, jp, h, w) for k in keys])
    got = engine.apply_strong(torch.from_numpy(image), torch.from_numpy(partner),
                              draws, tp).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert np.abs(got - image).max() > 0.1       # it did something


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["TransformsColor", "TransformsColorMixup"])
def test_augment_batch_from_mirrored_draws(preset):
    """JAX ``augment_batch`` (NHWC) against the port's finalize(apply(draws))
    (NCHW): per-sample keys, ``fold_in(k, 7)`` for the strong stream and the
    batch's mixup shift (engine.py:483-498).  Base tolerance for image,
    label, scribble and mask; the strong image within 1e-3 on 99.9%."""
    extra = dict(p_mixup=0.8) if preset.endswith("Mixup") else {}
    jbp, tbp = _base_params(**{**ON, "p_scale": 0.5, "p_rotate": 0.5})
    jsp = JaxStrong.color(1.0, **extra)
    tsp = strong_params_for(preset)
    assert dataclasses.asdict(jsp) == dataclasses.asdict(tsp)
    sizes = [(64, 64), (90, 80), (48, 56), (64, 72)]
    n = len(sizes)
    raw = _raw(13, sizes, 96)
    rng = jax.random.PRNGKey(21)
    want = {k: np.asarray(v) for k, v in jax_engine.augment_batch(
        {k: jnp.asarray(v) for k, v in raw.items()}, rng, jbp, jsp, True).items()}

    keys = jax.random.split(rng, n + 1)
    base_draws = _stack([jax_base_draws(k, jbp) for k in keys[:n]])
    strong_draws = _stack([jax_strong_draws(jax.random.fold_in(k, 7), jsp, *CROP)
                           for k in keys[:n]])
    shift = jax.random.randint(keys[n], (), 1, max(n, 2))
    base = engine.apply_base(_torch_raw(raw), base_draws, tbp)
    partners = engine.mixup_partners(base["image"], torch.tensor(int(shift)))
    np.testing.assert_array_equal(
        partners.numpy(), np.roll(base["image"].numpy(), int(shift), axis=0))
    strong = engine.apply_strong(base["image"], partners, strong_draws, tsp)
    got = engine._finalize(C, base, True, strong)

    assert sorted(got) == sorted(want)
    for k, v in got.items():
        w = np.moveaxis(want[k], -1, 1)
        assert tuple(v.shape) == w.shape and v.dtype == torch.float32, k
        if k == "valid_mask":
            np.testing.assert_array_equal(v.numpy(), w)
        elif k in ("image", "image_strong"):
            assert (np.abs(v.numpy() - w) > 1e-3).mean() <= 1e-3, k
        else:                       # one-hot planes: share of differing pixels
            assert (v.numpy() != w).any(axis=1).mean() <= 1e-3, k
    assert got["label"].shape[1] == C and got["scribble"].shape[1] == C + 1


def test_finalize_one_hot_of_the_ignored_index():
    """An ignored label pixel is an all-zero row; an ignored scribble pixel
    is the last channel (``jax.nn.one_hot`` semantics)."""
    lab = torch.tensor([[[0, 1], [C, C - 1]]], dtype=torch.int32)
    out = engine._finalize(C, {"image": torch.zeros(1, 2, 2), "label": lab,
                               "scribble": lab,
                               "valid_mask": torch.ones(1, 2, 2)}, False)
    assert "image_strong" not in out
    np.testing.assert_array_equal(
        out["label"].numpy(), np.moveaxis(np.asarray(jax.nn.one_hot(lab.numpy(), C)), -1, 1))
    np.testing.assert_array_equal(
        out["scribble"].numpy(),
        np.moveaxis(np.asarray(jax.nn.one_hot(lab.numpy(), C + 1)), -1, 1))
    assert out["label"][0, :, 1, 0].sum() == 0
    assert out["scribble"][0, C, 1, 0] == 1


# ---------------------------------------------------------------------------
# draw
# ---------------------------------------------------------------------------

N_DRAWS = 20_000


def _check_gate(hit, p, what):
    rate = float(hit.float().mean())
    assert abs(rate - p) <= 4 * np.sqrt(p * (1 - p) / hit.numel()) + 1e-12, (what, rate, p)


def _check_range(values, lo, hi, what):
    m = values.numel()
    assert m > 100, what
    mean, se = float(values.double().mean()), (hi - lo) / np.sqrt(12 * m)
    assert abs(mean - (lo + hi) / 2) <= 4 * se, (what, mean)
    vmin, vmax = float(values.min()), float(values.max())
    slack = (hi - lo) * 10 / m
    assert lo - 1e-6 <= vmin <= lo + slack and hi - slack <= vmax <= hi + 1e-6, \
        (what, vmin, vmax)


def test_draw_base_rates_and_ranges():
    p = BaseAugParams(crop_size=(8, 8), p_rot90=0.3)
    d = engine.draw_base(N_DRAWS, p, torch.Generator().manual_seed(0), "cpu")
    for name, gate, prob, rng, identity, factor in (
            ("scale", d["scale"] != 1.0, p.p_scale, p.scale_range, 1.0, 1.0),
            ("alpha", d["alpha"] != 0.0, p.p_elastic, p.alpha_range, 0.0, 1.0),
            ("theta", d["theta"] != 0.0, p.p_rotate, p.degree_range, 0.0,
             np.pi / 180.0),
            ("noise_scale", d["noise_scale"] != 0.0, p.p_noise,
             p.noise_scale_range, 0.0, 1.0)):
        _check_gate(gate, prob, name)
        _check_range(d[name][gate] / factor, *rng, name)
        assert bool((d[name][~gate] == identity).all()), name
    _check_range(d["sigma"], *p.sigma_range, "sigma")
    _check_gate(d["flip_y"], p.p_mirror_y, "flip_y")
    _check_gate(d["flip_x"], p.p_mirror_x, "flip_x")
    _check_gate(d["k90"] != 0, p.p_rot90, "k90")
    for k in p.rot90_choices:
        _check_gate(d["k90"][d["k90"] != 0] == k, 1 / 3, f"k90={k}")
    for j in range(4):
        _check_range(d["crop_u"][:, j], 0.0, 1.0, f"crop_u[{j}]")
    _check_range(d["elastic_noise"].flatten(), 0.0, 1.0, "elastic_noise")
    assert tuple(d["elastic_noise"].shape) == (N_DRAWS, 2, 2, 2)
    noise = d["noise"].double()
    assert tuple(noise.shape) == (N_DRAWS, 8, 8)
    assert abs(float(noise.mean())) <= 4 / np.sqrt(noise.numel())
    assert abs(float(noise.std()) - 1) <= 4 / np.sqrt(2 * noise.numel())
    off = engine.draw_base(16, BaseAugParams(crop_size=(8, 8)),
                           torch.Generator().manual_seed(0), "cpu")
    assert bool((off["k90"] == 0).all())        # Rotation90 is off by default


def test_draw_strong_rates_and_ranges():
    p = StrongAugParams.color(1.0, p_blur=0.8, p_mixup=0.8, p_lowres=0.8,
                              p_cutout=0.2)
    d = engine.draw_strong(N_DRAWS, 48, 64, p, torch.Generator().manual_seed(1),
                           "cpu")
    on = d["brightness"] != 0.0
    _check_gate(on, p.p_brightness, "brightness")
    _check_range(d["brightness"][on], *p.brightness_range, "brightness")
    on = d["contrast"] != 1.0
    _check_gate(on, p.p_contrast, "contrast")
    _check_range(d["contrast"][on], *p.contrast_range, "contrast")
    _check_gate(d["do_gamma"], p.p_gamma, "gamma")
    gamma = d["gamma"][d["do_gamma"]]
    assert bool((d["gamma"][~d["do_gamma"]] == 1.0).all())
    lo, hi = p.gamma_range                      # half below 1, half above
    _check_gate(gamma < 1.0, 0.5, "gamma<1")
    _check_range(gamma[gamma < 1.0], lo, 1.0, "gamma low")
    _check_range(gamma[gamma >= 1.0], 1.0, hi, "gamma high")
    _check_gate(d["do_blur"], p.p_blur, "blur")
    _check_range(d["blur_sigma"], *p.blur_sigma_range, "blur_sigma")
    on = d["lam"] != 1.0
    _check_gate(on, p.p_mixup, "mixup")
    _check_range(d["lam"][on], *p.mixup_lam_range, "lam")
    _check_gate(d["do_lowres"], p.p_lowres, "lowres")
    _check_range(d["lowres_scale"], *p.lowres_scale_range, "lowres_scale")
    _check_gate(d["do_cutout"], p.p_cutout, "cutout")
    assert 0 <= int(d["cut_y"].min()) and int(d["cut_y"].max()) == 47
    assert 0 <= int(d["cut_x"].min()) and int(d["cut_x"].max()) == 63
    assert 1 <= int(d["mixup_shift"]) < N_DRAWS
    plain = engine.draw_strong(4, 8, 8, StrongAugParams(),
                               torch.Generator().manual_seed(1), "cpu")
    assert sorted(plain) == ["brightness", "contrast", "do_gamma", "gamma",
                             "mixup_shift"]
    shifts = {int(engine.draw_strong(1, 8, 8, StrongAugParams(),
                                     torch.Generator().manual_seed(s),
                                     "cpu")["mixup_shift"]) for s in range(4)}
    assert shifts == {1}                        # a batch of one mixes with itself


def test_draws_repeat_from_a_seed_and_differ_between_samples():
    bp = BaseAugParams(crop_size=(16, 16), **{**ON, "p_rot90": 0.5})
    sp = StrongAugParams.color(1.0, p_mixup=0.8)
    runs = []
    for seed in (3, 3, 4):
        g = torch.Generator().manual_seed(seed)
        runs.append({**engine.draw_base(6, bp, g, "cpu"),
                     **engine.draw_strong(6, 16, 16, sp, g, "cpu")})
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
    for k in ("scale", "sigma", "alpha", "theta", "crop_u", "elastic_noise",
              "noise", "brightness", "contrast", "gamma"):
        assert not torch.equal(runs[0][k], runs[2][k]), k
    for k in ("sigma", "crop_u", "elastic_noise", "noise"):     # never gated
        assert len({tuple(row.flatten().tolist()) for row in runs[0][k]}) == 6, k
    # The global generator is not touched.
    torch.manual_seed(0)
    before = torch.get_rng_state()
    engine.augment_batch(_torch_raw(_raw(1, SQUARE, 64)),
                         torch.Generator().manual_seed(5),
                         dataclasses.replace(bp, crop_size=CROP, num_classes=C,
                                             ignored_index=C), sp, True)
    assert torch.equal(before, torch.get_rng_state())


# ---------------------------------------------------------------------------
# the whole engine, statistically
# ---------------------------------------------------------------------------

STAT_SPEC = aug_parity.ParitySpec(
    "chaos", 5, 5, (96, 96),
    ((96, 96), (96, 96), (80, 112), (112, 80), (72, 72)))


def _pad_batch(samples, canvas, ignored):
    def pad(x, fill):
        out = np.full((canvas, canvas), fill, np.float32)
        out[: x.shape[0], : x.shape[1]] = x
        return out
    return {"image": np.stack([pad(im, 0.0) for im, _, _ in samples]),
            "label": np.stack([pad(la, ignored) for _, la, _ in samples]),
            "scribble": np.stack([pad(sc, ignored) for _, _, sc in samples]),
            "size": np.stack([np.asarray(im.shape, np.int32)
                              for im, _, _ in samples])}


def _hard(batch, ignored, channel_axis):
    """One-hot batch -> hard maps the way ``aug_parity.run_ours`` reads them."""
    take = lambda k: np.take(batch[k], 0, axis=channel_axis)   # noqa: E731
    lab_oh = batch["label"]
    lab = np.where(lab_oh.sum(channel_axis) > 0, lab_oh.argmax(channel_axis), ignored)
    return {"image": take("image"), "image_strong": take("image_strong"),
            "valid_mask": take("valid_mask"), "label": lab.astype(np.float32),
            "scribble": batch["scribble"].argmax(channel_axis).astype(np.float32)}


def test_whole_engine_statistics_against_the_jax_engine():
    """192 phantoms at crop 96 (sizes around it, so crop and embed both run)
    through both engines, each from its own random stream, at the CHAOS
    probabilities and the ``TransformsColor`` preset."""
    spec = STAT_SPEC
    samples = aug_parity.gen_samples(192, seed=0, spec=spec)
    raw = _pad_batch(samples, 128, spec.ignored)
    kw = dict(crop_size=spec.crop, num_classes=spec.num_classes,
              ignored_index=spec.ignored)
    halves = [slice(0, 96), slice(96, 192)]
    fn = jax.jit(jax_engine.make_train_augment_fn(
        JaxBase(**kw), JaxStrong.color(1.0), do_strong=True))
    key = jax.random.PRNGKey(20)
    ref, ours = [], []
    gen = torch.Generator().manual_seed(20)
    for part in halves:
        key, sub = jax.random.split(key)
        chunk = {k: v[part] for k, v in raw.items()}
        ref.append(_hard(jax.device_get(fn(
            {k: jnp.asarray(v) for k, v in chunk.items()}, sub)),
            spec.ignored, -1))
        out = engine.augment_batch(_torch_raw(chunk), gen, BaseAugParams(**kw),
                                   strong_params_for("TransformsColor"), True)
        ours.append(_hard({k: v.numpy() for k, v in out.items()}, spec.ignored, 1))
    ref = {k: np.concatenate([r[k] for r in ref]) for k in ref[0]}
    ours = {k: np.concatenate([o[k] for o in ours]) for k in ours[0]}

    ks = aug_parity.ks_distance
    visible = lambda d, k: d[k][d["valid_mask"] > 0]            # noqa: E731
    assert ks(visible(ref, "image"), visible(ours, "image")) < 0.10
    assert ks(aug_parity.grad_mag(ref["image"], ref["valid_mask"]),
              aug_parity.grad_mag(ours["image"], ours["valid_mask"])) < 0.17
    assert ks(visible(ref, "image_strong"), visible(ours, "image_strong")) < 0.10
    rs = aug_parity.label_statistics(ref["label"], ref["valid_mask"], spec)
    os_ = aug_parity.label_statistics(ours["label"], ours["valid_mask"], spec)
    fg_ref, fg_ours = sum(rs["class_area"][1:]), sum(os_["class_area"][1:])
    assert abs(fg_ours - fg_ref) / fg_ref < 0.10, (fg_ref, fg_ours)
    assert abs(os_["ignored_frac"] - rs["ignored_frac"]) < 0.03
    assert abs(os_["valid_coverage"] - rs["valid_coverage"]) < 0.04
    ss = aug_parity.label_statistics(ref["scribble"], ref["valid_mask"], spec)
    so = aug_parity.label_statistics(ours["scribble"], ours["valid_mask"], spec)
    fg_ref, fg_ours = sum(ss["class_area"][1:]), sum(so["class_area"][1:])
    assert abs(fg_ours - fg_ref) / max(fg_ref, 1e-9) < 0.20, (fg_ref, fg_ours)


def test_augment_batch_invariants():
    """What ``chip_smoke.py`` checks on the card, here on the CPU: one-hot
    sums, the mask, and mean 0 / std 1 of the weak image inside the mask."""
    bp = BaseAugParams(crop_size=CROP, num_classes=C, ignored_index=C)
    raw = _torch_raw(_raw(14, [(64, 64), (90, 80), (48, 56), (96, 96)], 96))
    out = engine.augment_batch(raw, torch.Generator().manual_seed(2), bp,
                               StrongAugParams.color(1.0), True)
    assert bool((out["scribble"].sum(1) == 1).all())
    assert bool((out["label"].sum(1) <= 1).all())
    mask = out["valid_mask"]
    assert bool(((mask == 0) | (mask == 1)).all()) and float(mask.mean()) > 0.5
    cnt = mask.sum(dim=(1, 2, 3))
    mean = (out["image"] * mask).sum(dim=(1, 2, 3)) / cnt
    var = ((out["image"] - mean.view(-1, 1, 1, 1)) ** 2 * mask).sum(dim=(1, 2, 3)) / cnt
    assert float(mean.abs().max()) < 1e-3 and float((var.sqrt() - 1).abs().max()) < 1e-3
    assert bool((out["image"] * (1 - mask) == 0).all())
    assert not torch.equal(out["image"], out["image_strong"])
    base_only = engine.augment_batch(raw, torch.Generator().manual_seed(2), bp)
    assert sorted(base_only) == ["image", "label", "scribble", "valid_mask"]
    assert torch.equal(base_only["image"], out["image"])


def test_presets_match_the_jax_package():
    from pacingpseudo_tpu.aug import presets as jax_presets
    assert PRESETS == jax_presets.PRESETS
    for name in PRESETS:
        for strength in (1.0, 0.5):
            assert dataclasses.asdict(strong_params_for(name, strength)) == \
                dataclasses.asdict(jax_presets.strong_params_for(name, strength))
    for ds in ("chaos", "acdc", "lvsc"):
        ours = dataclasses.asdict(base_params_for(ds))
        theirs = dataclasses.asdict(jax_presets.base_params_for(ds))
        assert ours == theirs, ds           # the same fields and defaults
    with pytest.raises(ValueError):
        strong_params_for("TransformsNothing")


# ---------------------------------------------------------------------------
# eval preprocessing
# ---------------------------------------------------------------------------

def test_eval_preprocess_batch_and_image():
    raw = _raw(15, [(64, 64), (90, 80), (48, 56)], 96)
    want = jax_engine.eval_preprocess_batch(
        {k: jnp.asarray(v) for k, v in raw.items()}, C)
    got = engine.eval_preprocess_batch(_torch_raw(raw), C)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        w = np.moveaxis(np.asarray(want[k]), -1, 1)
        assert tuple(v.shape) == w.shape, k
        if k == "image":
            assert np.abs(v.numpy() - w).max() <= 1e-5 * np.abs(w).max()
        else:
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
    img = engine.eval_preprocess_image(torch.from_numpy(raw["image"]).half(),
                                       torch.from_numpy(raw["size"]))
    want_img = jax_engine.eval_preprocess_image(
        jnp.asarray(raw["image"]).astype(jnp.float16), jnp.asarray(raw["size"]))
    w = np.moveaxis(np.asarray(want_img), -1, 1)
    assert tuple(img.shape) == w.shape and img.dtype == torch.float32
    assert np.abs(img.numpy() - w).max() <= 1e-5 * np.abs(w).max()


# ---------------------------------------------------------------------------
# the step with an augment_fn
# ---------------------------------------------------------------------------

def test_train_step_with_augment_fn_equals_augment_then_step():
    config = ExperimentConfig(
        num_classes=C, ignored_index=C, init_ch=8, hid_ch=16, batch_size=2,
        session="Experiment", do_loss_ent=True, do_decoder_consistency=True,
        do_aux_path=True, do_memory=True, compute_dtype="float32").validate()
    bp = BaseAugParams(crop_size=CROP, num_classes=C, ignored_index=C)
    sp = strong_params_for(config.augmentations, config.strength)
    raw = _torch_raw(_raw(16, [(64, 64), (80, 72)], 96))
    augment_fn = engine.make_train_augment_fn(bp, sp, do_strong=True)

    fused_state = create_train_state(config, device="cpu", seed=7)
    fused = make_pacing_train_step(config, 4, augment_fn=augment_fn)
    m_fused = fused(fused_state, raw, torch.Generator().manual_seed(9))

    plain_state = create_train_state(config, device="cpu", seed=7)
    batch = engine.augment_batch(raw, torch.Generator().manual_seed(9), bp, sp, True)
    m_plain = make_pacing_train_step(config, 4)(plain_state, batch)

    assert sorted(m_fused) == sorted(m_plain)
    for k in m_plain:
        assert float(m_fused[k]) == float(m_plain[k]), k
    for (name, a), (_, b) in zip(fused_state.model.named_parameters(),
                                 plain_state.model.named_parameters()):
        assert torch.equal(a.grad, b.grad), name
        assert torch.equal(a, b), name
    assert fused_state.step == plain_state.step == 1
    with pytest.raises(ValueError, match="generator"):
        fused(fused_state, raw)
