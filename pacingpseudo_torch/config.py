"""Typed experiment configuration (the PyTorch port's own copy).

Field for field and default for default the same as
``pacingpseudo_tpu/config.py``, so a run configured for one package means
the same run in the other.  The port keeps its own copy instead of
importing it: nothing in ``pacingpseudo_torch`` imports the JAX package.

``s2d_hires``, which only steers the JAX package's TPU execution, is kept
for argv compatibility and is not read by the port.  ``num_devices`` and
``spatial_shards`` split the devices as in the JAX package
(``train/loop.py``): a data mesh runs, a split that needs height sharding
is refused.  ``steps_per_dispatch`` and
``device_resident_data`` steer the port's loop too (``train/loop.py``).  ``use_pallas_loss`` keeps its name and selects the port's fused
CUDA loss kernel: ``auto`` takes it when the logits lie on a CUDA device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Per-dataset constants.

    Reference sources: chaos_aug_configs.py:9-11 (5/5/(256,256)),
    acdc_aug_configs.py:9-11 (4/4/(224,224)), lvsc_aug_configs.py:9-13
    (2/2/(224,224)); spacings and per-dataset class counts from
    inference.py:55-67; class names from the dataset classname maps
    (chaos_dataset.py:17-24, acdc_dataset.py:13-19, lvsc_dataset.py:17-21).
    """

    name: str
    num_classes: int
    ignored_index: int
    input_size: Tuple[int, int]
    spacing: Tuple[float, float]
    classnames: Tuple[str, ...]
    # LVSC trains 40 epochs (inference.py:288 resolves ckp_39); others 400.
    default_epochs: int = 400


DATASETS = {
    "chaos": DatasetSpec(
        name="chaos", num_classes=5, ignored_index=5, input_size=(256, 256),
        spacing=(1.62, 1.62),
        classnames=("background", "liver", "right kidney", "left kidney", "spleen"),
    ),
    "chaost1": DatasetSpec(
        name="chaost1", num_classes=5, ignored_index=5, input_size=(256, 256),
        spacing=(1.62, 1.62),
        classnames=("background", "liver", "right kidney", "left kidney", "spleen"),
    ),
    "chaost2": DatasetSpec(
        name="chaost2", num_classes=5, ignored_index=5, input_size=(256, 256),
        spacing=(1.62, 1.62),
        classnames=("background", "liver", "right kidney", "left kidney", "spleen"),
    ),
    "acdc": DatasetSpec(
        name="acdc", num_classes=4, ignored_index=4, input_size=(224, 224),
        spacing=(1.51, 1.51),
        classnames=("background", "right ventricle", "myocardium", "left ventricle"),
    ),
    "lvsc": DatasetSpec(
        name="lvsc", num_classes=2, ignored_index=2, input_size=(224, 224),
        spacing=(1.48, 1.48),
        classnames=("background", "myo"),
        default_epochs=40,
    ),
}


@dataclasses.dataclass
class ExperimentConfig:
    """Flat run configuration mirroring the reference flag surface."""

    # Session (train_chaos.py:26-41)
    seed: int = 1
    dataset: str = "chaos"
    modality: str = "t1"            # chaos only: t1 | t2
    root: str = "./outputs/chaos"
    session: str = "Control"        # Control | Experiment | Upperbound
    tag: str = "run"
    fold: int = 1

    # Dataset / augmentation (train_chaos.py:50-61)
    num_classes: int = 5
    ignored_index: int = 5
    augmentations: str = "TransformsColor"
    strength: float = 1.0           # color-distortion strength (train_chaos.py:141)

    # Backbone (train_chaos.py:65-84)
    input_ch: int = 1
    init_ch: int = 32
    max_ch: int = 512
    output_stride: int = 8
    is_stride_conv: bool = False
    is_trans_conv: bool = False
    elab_end_points: bool = True

    # Optimizer (train_chaos.py:87-112)
    epoch: int = 400
    batch_size: int = 12
    optimizer: str = "adam"         # adam | momentum
    momentum: float = 0.9
    lr: float = 1e-4
    lr_decay: str = "poly"          # linear | poly | cosine
    wd: float = 3e-4
    ckp_interval: int = 10000

    # Entropy minimisation (train_chaos.py:116-126)
    do_loss_ent: bool = False
    loss_ent_weight: float = 1.0
    ramp_up_loss_ent: bool = True
    ramp_up_scale: float = 8.0

    # Decoder consistency (train_chaos.py:129-145)
    do_decoder_consistency: bool = False
    ramp_up_loss_cr: bool = True
    detach_weak_cr: bool = False
    loss_cr_variants: str = "ce_loss"   # ce_loss | l1_loss | l2_loss | kl_loss
    loss_cr_weight: float = 1.0

    # Auxiliary path (train_chaos.py:148-166)
    do_aux_path: bool = False
    feat_stage: Sequence[str] = ("encoder/stage6", "encoder/stage5")
    loss_aux_weight: float = 0.01
    hid_ch: int = 64
    aux_drop_prob: float = 0.0
    # True (default, reference behaviour): the aux path + memory bank read
    # the STRONG stream's encoder features whenever the consistency branch
    # runs — the torch UNet's shared end_points dict (unet.py:23) is
    # overwritten in place by the second (strong) forward before the aux
    # path consumes it (consistency_reglur_memory.py:48,74).
    aux_on_strong: bool = True

    # Memory bank (train_chaos.py:169-179)
    do_memory: bool = False
    loss_memory_weight: float = 1.0
    update_momentum: float = 0.9
    ensemble_mode: str = "cosine_similarity"  # cosine_similarity | mean

    # Upper-bound driver (upper_bound_chaos.py:81)
    loss_dice: bool = True

    # --- execution knobs (no reference equivalent) ---
    compute_dtype: str = "bfloat16"       # activation dtype: float32 | bfloat16
    fuse_streams: bool = True             # single 2N-batch siamese forward
    memory_update_mode: str = "first"     # 'first' = the reference's actual
                                          # published behaviour (the loop
                                          # return at aux_path_memory.py:116
                                          # means only the first sample of
                                          # each batch updates the bank);
                                          # 'all' is the fixed-bug variant
    ref_quirk_bn_eval_after_first_epoch: bool = False
    # Reference drivers call model.eval() for validation and never switch
    # back (train_chaos.py:370, upper_bound_chaos.py:183), freezing BN in
    # running-stats mode from epoch 1 on.  True reproduces that.
    num_devices: int = 0                  # 0 = all visible devices (data mesh)
    spatial_shards: int = 0               # shard activation H over a 'space'
                                          # mesh axis (parallel/spatial.py);
                                          # 0 = auto: split data x space so
                                          # ALL devices carry load when the
                                          # batch doesn't divide the chip
                                          # count (e.g. batch 12 on 8 chips
                                          # -> data 4 x space 2)
    aug_image_interp: str = "bicubic"     # fused-warp image kernel: "bicubic"
                                          # (measured parity, AUG_PARITY.json)
                                          # or "bilinear" (max throughput)
    s2d_hires: bool = True                # space-to-depth execution of the
                                          # high-res stage-1 blocks (JAX
                                          # package only; the port runs the
                                          # logical layout)
    steps_per_dispatch: int = 8           # train steps a dispatch (JAX: one
                                          # scanned XLA program; the port:
                                          # replays of a CUDA graph of the
                                          # step on a card; 1 disables)
    device_resident_data: str = "auto"    # stage the whole training set in
                                          # HBM (f16/u8) and send only batch
                                          # indices per step: auto (single
                                          # device & pool < 6 GB) | on | off
    use_pallas_loss: str = "auto"         # fused loss kernel for the
                                          # pce/ent/soft-ce reduction:
                                          # auto (CUDA tensors only) | on | off
    resume: bool = False                  # resume from latest checkpoint
    input_size: Optional[Tuple[int, int]] = None  # override the dataset's
                                          # crop size (debug/smoke runs)
    tb_figures: bool = True               # per-epoch TB figure panels
                                          # (train_chaos.py:321-360)
    profile_dir: str = ""                 # write one profiler trace of
                                          # epoch start+1 here (empty = off)

    @property
    def spec(self) -> DatasetSpec:
        return DATASETS[self.dataset]

    def validate(self):
        assert self.session in ("Control", "Experiment", "Upperbound")
        assert self.optimizer in ("adam", "momentum")
        assert self.lr_decay in ("linear", "poly", "cosine")
        assert self.loss_cr_variants in ("ce_loss", "l1_loss", "l2_loss", "kl_loss")
        assert self.ensemble_mode in ("cosine_similarity", "mean")
        assert self.memory_update_mode in ("all", "first")
        assert self.output_stride in (8, 16, 32)
        assert self.compute_dtype in ("float32", "bfloat16")
        assert self.use_pallas_loss in ("auto", "on", "off")
        assert self.device_resident_data in ("auto", "on", "off")
        assert self.aug_image_interp in ("bicubic", "bilinear"), \
            self.aug_image_interp
        assert self.spatial_shards >= 0, self.spatial_shards
        if self.do_memory:
            assert self.do_aux_path, "do_memory requires do_aux_path"
        return self
