"""A run of a cell, cut to the CPU's size, with the timed path broken
underneath: ``correct`` comes out false for each fault a one-card training
cell can have, and true for the sound program.

The program runs in float32 here, where it equals the reference to the
bit (``test_bench_reference.py``), so each number reads 0 unless a fault
moves it."""
import time

import pytest

from conftest import tiny_cell
from harness import cell as C

CELLS = ["chaos-experiment.train", "chaos-upperbound.train"]


def _run(workload):
    return C.run_cell(tiny_cell(workload), 2**31 + 5, 0.0, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("workload", CELLS)
def test_the_sound_program_is_correct(workload):
    run = _run(workload)
    assert run.result["correct"] is True, run.stderr_lines
    assert list(run.result)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, fault):
    import controls
    with controls.planted(fault):
        run = _run(workload)
    assert run.result["correct"] is False
    failed = {name for name, c in run.result["checks"].items() if c["value"] > c["limit"]}
    if fault == "unchanged":
        assert "update" in failed
    else:
        # The forward runs on the whole batch, so the augmented batch and the
        # outputs are sound; the first gradient is not.
        assert "grad" in failed and not {"aug_image", "aug_maps", "outputs"} & failed


def test_a_mix_lays_flags_and_env_over_the_configuration(monkeypatch):
    """A mix's ``flags`` reach the program's configuration and its ``env``
    the process, so a later cell that runs the model another way is a mix
    file alone; the run stays correct."""
    import os
    monkeypatch.delenv("PACING_CONV_IMPL", raising=False)
    cell = tiny_cell("chaos-upperbound.train")
    cell.mix.update(flags={"steps_per_dispatch": 1}, env={"PACING_CONV_IMPL": "xla"})
    assert C.program_config(cell.flags, cell.mix, 1).steps_per_dispatch == 1
    run = C.run_cell(cell, 2**31 + 7, 0.0, False, "cpu", time.perf_counter())
    assert run.result["correct"] is True, run.stderr_lines
    assert os.environ["PACING_CONV_IMPL"] == "xla"
