"""JAX's initial variables of a run, drawn as its loop draws them, for the port.

    JAX_PLATFORMS=cpu python tests/jax_init.py \\
        --config study_r3/Control/run-fold0/config.json \\
        --out build/jax_init/control_seed1.pt
    JAX_PLATFORMS=cpu python tests/jax_init.py \\
        --config study_r5/sweep/Experiment80.log \\
        --out build/jax_init/experiment80_seed1.pt

``pacingpseudo_tpu.train.loop`` draws a run's variables with
``create_train_state(jax.random.PRNGKey(config.seed), model, tx, template)``
(``train/loop.py:379-383``, ``train/state.py:45-49``): the model of
``_build_model(config, siamese)`` initialised on a zero batch.  Flax draws
each parameter from a key folded from the run's key and the parameter's
scope path, at a shape set by the channels alone, so the draw is the same for
any batch and height: this module initialises on a small template (batch 2,
64x64 by default) and checks that a second template (batch 1, 96x96) draws
every leaf bit for bit the same.  The variables go through the port's
``pacingpseudo_torch.tools.weights.from_jax_variables`` and are saved with
``torch.save`` as the port's state_dict.  The sha256 printed is over the
state_dict's tensors (``scripts/control_from_jax_init.py``'s
``state_dict_digest``), the leaf count its length; that script trains the
port from the file on a card and prints the same two figures.

Used by ``tests/test_torch_port_init.py`` (``draw``) at a small width; as a
script at the config's own width (init_ch 32: ~80 MB of float32).  JAX's
``model.init`` is compiled at XLA's lowest backend optimisation, which only
shortens the compile.  A test helper, not a test: it imports JAX and the JAX
package, which the port's scripts never do.

``--config`` is a run's ``config.json``, or an arm log of the JAX CLI
(``study_r5/sweep/Control80.log``), whose first ``config:`` line is read: the
run of fold 0 at the log's seed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pacingpseudo_tpu.config import ExperimentConfig  # noqa: E402
from pacingpseudo_tpu.train import loop as jax_loop  # noqa: E402
from pacingpseudo_tpu.train.optim import make_optimizer  # noqa: E402
from pacingpseudo_tpu.train.state import create_train_state  # noqa: E402
from scripts.control_from_jax_init import state_dict_digest  # noqa: E402


class _JitInit:
    """``model.init`` compiled at XLA's lowest backend optimisation."""

    def __init__(self, model):
        self.model = model

    def init(self, *args, **kw):
        lowered = jax.jit(self.model.init, static_argnames=("train",)).lower(*args, **kw)
        return lowered.compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def config_of(run_config: dict) -> ExperimentConfig:
    """JAX's ``ExperimentConfig`` of a run's ``config.json``."""
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    kw = {k: v for k, v in run_config.items() if k in fields}
    for k in ("feat_stage", "input_size"):
        if isinstance(kw.get(k), list):
            kw[k] = tuple(kw[k])
    return ExperimentConfig(**kw)


def read_config(path: str) -> dict:
    """The run config of ``path``: a ``config.json``, or the first
    ``config: {...}`` line of a JAX arm log."""
    with open(path) as f:
        text = f.read()
    if text.lstrip().startswith("{"):
        return json.loads(text)
    for line in text.splitlines():
        if line.startswith("config: "):
            return json.loads(line[len("config: "):])
    raise SystemExit(f"{path}: neither a config.json nor a log with a config: line")


def draw(config: ExperimentConfig, batch: int = 2, size: int = 64):
    """``(params, batch_stats, memory_bank)`` as numpy (trees), drawn as the
    loop draws a run of ``config`` (siamese unless the Upperbound session;
    the bank ``None`` without ``do_memory``)."""
    siamese = config.session != "Upperbound"
    model = jax_loop._build_model(config, siamese)
    template = {"image": jnp.zeros((batch, size, size, 1), jnp.float32)}
    state = create_train_state(jax.random.PRNGKey(config.seed), _JitInit(model),
                               make_optimizer(config, 1), template,
                               with_memory=config.do_memory and siamese,
                               num_classes=config.num_classes, hid_ch=config.hid_ch,
                               siamese=siamese)
    bank = None if state.memory_bank is None else np.asarray(state.memory_bank)
    return (jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.batch_stats), bank)


def main(argv=None):
    import torch

    from pacingpseudo_torch.tools.weights import from_jax_variables
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join("study_r3", "Control", "run-fold0",
                                                     "config.json"))
    ap.add_argument("--out", default=os.path.join("build", "jax_init", "control_seed1.pt"))
    args = ap.parse_args(argv)
    config = config_of(read_config(args.config))
    params, stats, bank = draw(config)
    again = draw(config, batch=1, size=96)
    same = all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves((params, stats, bank)),
                                                    jax.tree.leaves(again)))
    if not same:
        raise SystemExit("the draw depends on the template's shape")
    sd = from_jax_variables(params, stats, bank)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(sd, args.out)
    print(json.dumps({"out": args.out, "seed": config.seed, "s2d_hires": config.s2d_hires,
                      "init_ch": config.init_ch, "leaves": len(sd),
                      "sha256": state_dict_digest(sd),
                      "bytes": os.path.getsize(args.out)}))


if __name__ == "__main__":
    main()
