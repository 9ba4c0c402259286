"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as one JSON object on the last line of standard
output, and each number the check compared, beside its limit, as the last
lines of standard error.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled span of the
window.  Exits non-zero, with no result, without the CUDA devices the cell
asks for, or when JAX or the JAX package was imported.  See README.md.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Build and kernel caches at fixed paths inside the checkout.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "bench_cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "bench_cache" / "triton"))
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "pacingpseudo_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from harness import cell as C

    spec = C.load_cell(args.workload)
    chips = next(w["chips"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())
                 ["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import pacingpseudo_torch  # noqa: F401  (the system under test: no result without it)

    run = C.run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                     T_START)
    found = forbidden_modules()
    if found:
        print("imported in the run's process: " + ", ".join(found), file=sys.stderr)
        return 3
    for line in run.stderr_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(run.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
