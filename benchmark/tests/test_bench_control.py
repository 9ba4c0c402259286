"""The check's control: the plain reference computed a precision below the
configuration's (every convolution's operands in float8 e4m3 instead of
bfloat16), put in the program's place, comes out not correct.

On the CPU at 64x64 and init_ch 8 against each cell's limits; on the card
(``-m card``) at the cell's own size, where the program itself must come
out correct on the same seed."""
import pytest
import torch

from conftest import tiny_cell
from harness import cell as C, check, data

CELLS = ["chaos-experiment.train", "chaos-upperbound.train"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_fp8_control_is_not_correct(workload):
    cell = tiny_cell(workload, "bfloat16")
    f, mix, seed = cell.flags, cell.mix, 23
    dev = torch.device("cpu")
    pools = data.make_pool(mix, f, seed, dev)
    init = C.make_initial_state(f, pools, seed, dev)
    n = pools["train"]["image"].shape[0]
    spe = n // f["batch_size"]
    blocks = C.epoch_blocks(seed, mix["start_epoch"], n, spe, f["batch_size"])
    args = (f, mix, init, pools["train"], pools["val"], blocks, seed,
            mix["start_epoch"] * spe, spe, dev)
    ref = C.reference_trace(*args)
    control = C.reference_trace(*args, precision="fp8")
    correct, _ = check.verdict(check.compare(control, ref), cell.limits)
    assert not correct


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_on_the_card_the_program_passes_and_the_control_fails(workload, card):
    import controls
    cell = C.load_cell(workload)
    cell.mix["host_processes"] = 1      # no worker processes under pytest
    got = controls.readings(cell, 2**31 + 99, ["fp8"], card)
    limits = cell.limits
    assert check.verdict(got["program"], limits)[0], got["program"]
    assert not check.verdict(got["fp8"], limits)[0], got["fp8"]
