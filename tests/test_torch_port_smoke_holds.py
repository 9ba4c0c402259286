"""The branch matching of ``chip_smoke.py``'s rank holds, on the CPU.

In float32 the smoke's yardstick updates and the ranks' update take the
single-card update's LeakyReLU branches (``_record_signs(..., branches)``),
each rank its block of them (``_rank_block(..., every_rank=True)``).  Held
here: branches that match the natural ones change no bit of the output or
the gradients, and the natural signs are recorded either way; a forced
branch gives exactly the gradient of a forward built with that slope; and a
space rank's block of a replicated level is the whole level on every rank
only when asked.  Small layers, exact comparisons.
"""
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from pacingpseudo_torch.models.unet import NEGATIVE_SLOPE, ConvLayer  # noqa: E402
from pacingpseudo_torch.parallel import spatial  # noqa: E402


@pytest.fixture(scope="module")
def layers():
    torch.manual_seed(0)
    return torch.nn.Sequential(ConvLayer(3, 8), ConvLayer(8, 4)).train()


X = torch.randn(2, 3, 12, 12, generator=torch.Generator().manual_seed(1))


def _run(model, branches=None):
    model.zero_grad(set_to_none=True)
    signs = []
    hooks = smoke._record_signs(model, signs, branches)
    out = model(X)
    weight = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
    (out * weight).sum().backward()
    for hook in hooks:
        hook.remove()
    return out.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}, signs


def test_matched_branches_change_nothing(layers):
    out, grads, signs = _run(layers)
    out_m, grads_m, signs_m = _run(layers, [s.clone() for s in signs])
    assert len(signs) == 2
    assert torch.equal(out, out_m)
    assert all(torch.equal(grads[k], grads_m[k]) for k in grads)
    assert all(torch.equal(a, b) for a, b in zip(signs, signs_m))


@pytest.mark.parametrize("pixel", [(0, 1, 5, 7), (1, 6, 0, 11)])
def test_a_forced_branch_takes_the_other_slope(layers, pixel):
    _, grads, signs = _run(layers)
    branches = [s.clone() for s in signs]
    branches[0][pixel] = ~branches[0][pixel]
    _, grads_f, signs_f = _run(layers, branches)
    assert torch.equal(signs_f[0], signs[0])          # the natural sign, recorded
    assert not torch.equal(grads_f["0.conv.weight"], grads["0.conv.weight"])

    # The same forward with each layer's slope taken from ``branches``.  The
    # hook scales the LeakyReLU's output (by 1 / slope where the negative
    # branch turns positive), so it agrees to float32 rounding, not bit for
    # bit; the forced pixel alone moves the gradient far more.
    layers.zero_grad(set_to_none=True)
    h = X
    for layer, want in zip(layers, branches):
        pre = layer.norm_op(layer.conv(h))
        h = pre * torch.where(want, torch.ones_like(pre), torch.full_like(pre, NEGATIVE_SLOPE))
    (h * torch.linspace(-1, 1, h.numel()).reshape(h.shape)).sum().backward()
    for k, p in layers.named_parameters():
        torch.testing.assert_close(grads_f[k], p.grad, rtol=1e-5, atol=1e-5)
    moved = grads_f["0.conv.weight"] - grads["0.conv.weight"]
    assert float(moved.abs().max()) > 1e3 * float(
        (grads_f["0.conv.weight"] - layers[0].conv.weight.grad).abs().max())


def test_rank_block_of_a_replicated_level():
    n, rows = 2, slice(0, 2)
    # 48 x 48 at output stride 16 on 4 space ranks: the split level has 6
    # rows, the 3-row level below it is whole on every rank.
    splits = [spatial.HeightSplit.of(48, 16, 4, i, 48) for i in range(4)]
    level = torch.arange(2 * n * 3 * 3 * 3).reshape(2 * n, 3, 3, 3)
    split_level = torch.arange(2 * n * 6 * 6).reshape(2 * n, 1, 6, 6)
    blocks = []
    for i, split in enumerate(splits):
        assert (smoke._rank_block(level, rows, n, split, i) is None) == (i > 0)
        assert torch.equal(smoke._rank_block(level, rows, n, split, i, every_rank=True), level)
        blocks.append(smoke._rank_block(split_level, rows, n, split, i, every_rank=True))
        assert torch.equal(blocks[-1], smoke._rank_block(split_level, rows, n, split, i))
    assert all(0 < b.shape[-2] < 6 for b in blocks)
    assert torch.equal(torch.cat(blocks, dim=-2), split_level)
