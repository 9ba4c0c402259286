"""The yardstick's operation and byte counts against independent counts."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny_cell
from harness import flops


@pytest.mark.parametrize("workload", ["chaos-experiment.train", "chaos-upperbound.train"])
def test_update_flops_match_the_flop_counter(workload):
    """At 64x64 and init_ch 8 the model FLOPs of ``harness/flops.py`` equal
    what ``torch.utils.flop_counter`` counts on the port's own model, for
    the forward and for forward plus backward."""
    from harness.cell import program_config
    from pacingpseudo_torch.train.state import build_model
    cell = tiny_cell(workload)
    f = cell.flags
    config = program_config(f, cell.mix, 1)
    model = build_model(config, "cpu")
    n, s = f["batch_size"], f["input_size"][0]
    image = torch.randn(n, 1, s, s)
    strong = torch.randn(n, 1, s, s) if f["session"] == "Experiment" else None
    with FlopCounterMode(display=False) as fwd:
        out = model(image, strong, train=True)
    assert fwd.get_total_flops() == flops.forward_flops(f) * n
    with FlopCounterMode(display=False) as both:
        out = model(image, strong, train=True)
        sum(v.float().sum() for k, v in out.items() if k != "aux/features").backward()
    assert both.get_total_flops() == flops.update_flops(f)


def test_kernel_bytes_at_the_experiment_batch():
    """The bytes of the port's kernel table (PERF.md, rows 1, 2 and 6b)."""
    f = tiny_cell("chaos-experiment.train").flags
    f.update(input_size=[256, 256], batch_size=12)
    assert flops.fused_loss_bytes(f) == {"fwd_kernel": 40_894_508, "bwd_kernel": 72_351_756}
    assert flops.warp_cubic_bytes(f) == 25_166_016


def test_full_width_flops():
    """The full-width counts PERF.md quotes: 116.1 / 57.4 GFLOP a slice forward."""
    from harness import cell as C
    exp = C.load_cell("chaos-experiment.train").flags
    ub = C.load_cell("chaos-upperbound.train").flags
    assert flops.forward_flops(exp) == 116_082_212_864
    assert flops.forward_flops(ub) == 57_436_798_976
    assert flops.update_flops(exp) == 12 * 348_171_141_120
