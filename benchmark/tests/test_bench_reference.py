"""The plain reference against the port at 64x64 and init_ch 8 on the CPU.

In float32 both sides run the same arithmetic on the CPU (the port's
kernels fall back to their plain versions there, the fused loss is off),
so the augmented batch, the outputs, every loss term of the three updates,
the first gradient, the parameters' change, the BatchNorm statistics and
the bank, and the validation sums agree to the last bit.  In bfloat16 the
augmentation still agrees to the bit and the rest within the reference's
own bfloat16 distance."""
import pytest
import torch

from conftest import tiny_cell
from harness import cell as C, check, data

# The frozen-BatchNorm mix has no cell in BENCHMARK.json (PERF.md, Open
# questions); its path is held to the reference all the same.
CELLS = ["chaos-experiment.train", "chaos-upperbound.train", "chaos-experiment.frozen-bn"]


def _traces(workload, dtype, seed=11, **ref_kw):
    cell = tiny_cell(workload, dtype)
    f, mix = cell.flags, cell.mix
    dev = torch.device("cpu")
    pools = data.make_pool(mix, f, seed, dev)
    init = C.make_initial_state(f, pools, seed, dev)
    bs = f["batch_size"]
    n = pools["train"]["image"].shape[0]
    spe = n // bs
    start = mix["start_epoch"] * spe
    blocks = C.epoch_blocks(seed, mix["start_epoch"], n, spe, bs)
    prog = C.Program(f, mix, seed, init, pools, dev, start)
    p, _ = C.program_trace(prog, blocks, mix["start_epoch"], init)
    r = C.reference_trace(f, mix, init, pools["train"], pools["val"], blocks, seed, start, spe,
                          dev, **ref_kw)
    return p, r, init


@pytest.mark.parametrize("workload", CELLS)
def test_float32_program_equals_the_reference(workload):
    p, r, _ = _traces(workload, "float32")
    numbers = check.compare(p, r)
    assert all(v == 0.0 for v in numbers.values()), numbers
    assert p["terms"] == r["terms"]
    assert set(r["terms"][0]) >= ({"loss_pce", "loss_ent", "loss_cr", "loss_aux_cls",
                                   "loss_memory", "loss_total"}
                                  if "experiment" in workload else {"loss_ce", "loss_dice"})


@pytest.mark.parametrize("workload", CELLS)
def test_bfloat16_program_is_the_references_bfloat16(workload):
    """The program in its configured bfloat16 reads, against the float32
    reference, what the reference computed in bfloat16 reads."""
    p, r, _ = _traces(workload, "bfloat16")
    mine = check.compare(p, r)
    assert mine["aug_image"] == 0.0 and mine["aug_maps"] == 0.0
    assert mine["outputs"] > 0.0
    cell = tiny_cell(workload, "bfloat16")
    f, mix = cell.flags, cell.mix
    dev = torch.device("cpu")
    pools = data.make_pool(mix, f, 11, dev)
    init = C.make_initial_state(f, pools, 11, dev)
    n = pools["train"]["image"].shape[0]
    spe = n // f["batch_size"]
    blocks = C.epoch_blocks(11, mix["start_epoch"], n, spe, f["batch_size"])
    twin = C.reference_trace(f, mix, init, pools["train"], pools["val"], blocks, 11,
                             mix["start_epoch"] * spe, spe, dev, precision="bfloat16")
    assert check.compare(twin, r) == mine


def test_the_frozen_mix_leaves_the_running_statistics():
    """From epoch 1 the frozen mix's step normalises with the running
    statistics and leaves them; the bank still moves."""
    p, r, init = _traces("chaos-experiment.frozen-bn", "float32")
    for side in (p, r):
        for k, v in side["buffers"].items():
            assert torch.equal(v, init[k].float()) != k.endswith("memory_bank"), k
