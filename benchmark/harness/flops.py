"""Operations and bytes from a configuration's shapes: the yardstick of the
model-FLOP utilisation and of the kernels' roofline shares.

Model FLOPs count each convolution's multiply-adds twice, as
``torch.utils.flop_counter`` does, and nothing else (BatchNorm, LeakyReLU,
resizes and the losses are a fraction of a percent of them).  An update's
FLOPs are the forward's plus, for every convolution, the weight gradient and,
where the conv's input needs a gradient (every conv but the first, whose
input is the image), the input gradient, each as costly as the forward.
Nothing is recomputed in the step, so nothing more is counted.

Bytes count each input of a kernel read once and each output written once,
at the shapes the step launches it with (the byte arithmetic of the port's
``chip_smoke.py`` kernels phase).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple


class Conv(NamedTuple):
    name: str
    cin: int
    cout: int
    k: int
    h: int          # output height
    w: int          # output width
    images: int     # images a slice puts through it (2 for the siamese streams)
    input_grad: bool


def _unet_convs(f: Dict, images: int) -> List[Conv]:
    ch = [min(f["max_ch"], f["init_ch"] * 2 ** k) for k in range(6)]
    size = int(f["input_size"][0])
    stride = {32: (2, 2), 16: (2, 1), 8: (1, 1)}[f["output_stride"]]
    # spatial size of each encoder stage
    s = [size, size // 2, size // 4, size // 8]
    s.append(s[3] // stride[0])
    s.append(s[4] // stride[1])
    convs = []
    cin = f["input_ch"]
    for i in range(6):
        convs.append(Conv(f"enc{i + 1}.1", cin, ch[i], 3, s[i], s[i], images, i > 0))
        convs.append(Conv(f"enc{i + 1}.2", ch[i], ch[i], 3, s[i], s[i], images, True))
        cin = ch[i]
    up = ch[5]
    for i in (4, 3, 2, 1, 0):
        convs.append(Conv(f"dec{i + 1}.1", up + ch[i], ch[i], 3, s[i], s[i], images, True))
        convs.append(Conv(f"dec{i + 1}.2", ch[i], ch[i], 3, s[i], s[i], images, True))
        up = ch[i]
    convs.append(Conv("final", ch[0], f["num_classes"], 1, size, size, images, True))
    return convs


def model_convs(f: Dict) -> List[Conv]:
    """Every convolution one slice puts through the session's model."""
    if f["session"] == "Upperbound":
        return _unet_convs(f, 1)
    convs = _unet_convs(f, 2 if f["do_decoder_consistency"] else 1)
    if f["do_aux_path"]:
        ch = [min(f["max_ch"], f["init_ch"] * 2 ** k) for k in range(6)]
        width = {"encoder/stage5": ch[4], "encoder/stage6": ch[5]}
        deep = [c for c in convs if c.name == "enc6.2"][0]
        cin = sum(width[s] for s in f["feat_stage"])
        convs.append(Conv("aux.bottleneck", cin, f["hid_ch"], 3, deep.h, deep.w, 1, True))
        convs.append(Conv("aux.fc_cls", f["hid_ch"], f["num_classes"], 1, deep.h, deep.w, 1,
                          True))
    return convs


def conv_flops(c: Conv) -> int:
    """Forward FLOPs of ``c`` for one slice."""
    return 2 * c.images * c.cout * c.h * c.w * c.cin * c.k * c.k


def forward_flops(f: Dict) -> int:
    """Forward FLOPs of one slice."""
    return sum(conv_flops(c) for c in model_convs(f))


def update_flops(f: Dict) -> int:
    """FLOPs of one update: forward, weight gradients and input gradients
    of the whole batch."""
    per_slice = sum(conv_flops(c) * (2 + c.input_grad) for c in model_convs(f))
    return per_slice * int(f["batch_size"])


# ---- kernel bytes (each input read once, each output written once)

def fused_loss_bytes(f: Dict) -> Dict[str, int]:
    """Bytes of ``fwd_kernel`` and ``bwd_kernel`` at one update's shapes: two
    float32 logit fields, the int64 target, the float32 mask; the forward
    writes 11 floats, the backward reads 3 scales and writes two gradient
    fields."""
    n, c = int(f["batch_size"]), int(f["num_classes"])
    h, w = (int(v) for v in f["input_size"])
    logits = n * c * h * w * 4
    target, mask = n * h * w * 8, n * h * w * 4
    return {"fwd_kernel": 2 * logits + target + mask + 11 * 4,
            "bwd_kernel": 2 * logits + target + mask + 3 * 4 + 2 * logits}


def warp_cubic_bytes(f: Dict) -> int:
    """Bytes of ``warp_cubic_kernel`` at one update's shapes: three float32
    planes and the two float32 coordinate maps read, four (N,) float32
    vectors (extents, clip range), the image and two int32 class maps
    written."""
    n = int(f["batch_size"])
    h, w = (int(v) for v in f["input_size"])
    plane = n * h * w * 4
    return 3 * plane + 2 * plane + 4 * n * 4 + 3 * plane
