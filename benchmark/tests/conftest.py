"""Shared pieces of the benchmark's CPU tests: the ``card`` marker and a
cell cut to a size the CPU runs in seconds."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for path in (str(BENCH.parent), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """A CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: python -m pytest benchmark/tests -m card)")
    return torch.device("cuda", 0)


def tiny_cell(workload: str, dtype: str = "float32"):
    """The cell ``workload`` at 64x64, init_ch 8, hid_ch 16, batch 2, on a
    20-slice pool: every shape and path of the cell, at a CPU's size."""
    import json
    from harness import cell as C
    cells = {w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())
             ["workloads"]}
    if workload in cells:
        cell = C.load_cell(workload)
    else:       # "<config>.<traffic>" of files that no cell names yet
        config, traffic = workload.split(".", 1)
        cell = C.Cell(workload, json.loads((BENCH / "configs" / f"{config}.json").read_text()),
                      json.loads((BENCH / "mixes" / f"{traffic}.json").read_text()), {}, [], [])
    cell.config["flags"].update(input_size=[64, 64], init_ch=8, max_ch=64, hid_ch=16,
                                batch_size=2, compute_dtype=dtype)
    cell.mix.update(train_slices=20, val_slices=4, train_phantoms=2, val_phantoms=2,
                    warmup_updates=8, host_processes=1)
    return cell


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
