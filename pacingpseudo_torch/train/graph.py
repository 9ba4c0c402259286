"""One train step captured as a CUDA graph and replayed.

The port's counterpart of the JAX loop's ``lax.scan`` over ``K`` steps in
one dispatch: on the card the host's ~2,000 launches of an eager step
become one graph launch.  :class:`StepGraph` is used by the chunked steps
of ``train/step.py`` with ``chunk > 1`` on a card; there is no eager
fallback: a capture or replay that fails raises.

What a replay must not bake in, and what it does about it:

* **Host scalars.**  The step reads its epoch (the loss ramps and the
  bank's momentum follow from it) and its learning rate on the host
  (``step.scalars(n)``, a :class:`~pacingpseudo_torch.train.step.
  StepScalars`); both change once an epoch.  A graph is captured for one
  step function and one value of ``scalars``, and captured again when
  either changes: a replay uses exactly the values the eager step would.
* **The optimizer.**  Adam's bias correction reads its step count; the
  optimizer is made capturable (``optim.make_capturable``: the counts live
  on the card, the correction is computed there at each replay; float32,
  so not bit-equal to the eager Adam).  SGD reads nothing from the host.
* **Random draws.**  The augmentation's generator is registered with the
  graph and the device's default generator (dropout's) is registered by
  the capture itself; the caller's ``reseed(n)`` seeds both before each
  replay, so update ``n`` draws what the eager update ``n`` draws.
* **State the kernels keep between calls** (the fused loss's and
  ``bn_sums``' ticket counters, allocated once a card) and everything
  PyTorch initialises lazily (cuBLAS/cuDNN handles, the optimizer's
  state) exist before the capture: each capture is preceded by one real
  update, run eagerly on the capture stream.
* **Launch counts.**  A wrapper adds to its ``LAUNCHES`` (and ``ROUTES``)
  count where it launches its kernel; inside a capture it launches nothing
  but is counted all the same.  So the counts a capture adds are taken back
  when it ends and added again at every replay, which launches them: the
  counters count the eager update and each replay, as an eager run would.
* **Inputs.**  The step reads static tensors that the host refills before
  each replay (a raw batch, or an index block into a resident pool); its
  metrics are static outputs that the next replay overwrites.
* **Ranks.**  A step with NCCL ranks (``parallel/mesh.py``) is captured
  with its collectives, the same update on every rank: the key below
  changes at the same update everywhere, so every rank captures and
  replays in step, and its collectives keep one order.  The eager update
  before each capture creates every communicator the step uses (NCCL makes
  one at its first collective, which a capture cannot do), and fills the
  caches of device constants that height sharding keeps
  (``parallel/spatial.py``; an upload inside a capture raises there).  The
  capture runs in ``capture_error_mode="thread_local"``: in the default
  ``"global"`` mode CUDA refuses every thread's unsafe calls while a
  capture is under way, and ProcessGroupNCCL's watchdog thread queries the
  events of earlier collectives all along; ``"thread_local"`` holds only
  the capturing thread to the rule, which is the one that records the
  step.  Eager collectives run on the same communicators between
  replays (the validation's sums, the sharded pool's gather of the figure
  batch), which NCCL allows.  Ranks on gloo are never captured
  (``train.step.uses_graph``).
* **Memory.**  A :class:`StepGraph` holds one graph at a time.  The next
  one (the frozen-BN step, the next epoch) is captured into the old one's
  private pool, so it reuses the memory the old one's temporaries held,
  and the old one is released after: graphs that never run at once share
  one pool.  (Released first, the old graph would take the pool with it.)
  Before a capture the allocator's cached blocks go back to the card, as
  ``torch.cuda.graph`` does: a private pool cannot use them.  When the
  caller is done, :meth:`StepGraph.reset` releases the graph; the
  parameters' gradients of the last replay live in its pool until the next
  ``zero_grad``.

What it measures (``utils/trace.py``): a capture is the host span
``graph.capture``, with one child span each for the drain
(``graph.drain``, the ``synchronize``), ``graph.empty_cache``, the eager
update (``graph.eager_update``) and the capture itself (``graph.record``).
The whole update, gather included, is one device-phase region
(``trace.update``), so the captured graph records the phase events at
every replay; the capture that replaces a replayed graph reads them after
its ``synchronize``, before the eager update records them again: one
sample of the last replayed update a capture, and no host read on the
replay path.  ``captures`` and ``replays`` count this object's.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional

import torch

from pacingpseudo_torch.train.optim import make_capturable
from pacingpseudo_torch.utils import trace


class StepGraph:
    """At most one captured train step, replayed update after update."""

    def __init__(self):
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._key = None
        self._static: Dict[str, torch.Tensor] = {}
        self._metrics: Dict = {}
        self._launches = ()     # (counter, a replay's launches) per counter that grows
        self._stream: Optional[torch.cuda.Stream] = None
        self.captures = 0
        self.replays = 0
        self._replayed = False      # the graph has replayed since its capture

    def run(self, step: Callable, state, inputs: Dict[str, torch.Tensor],
            to_batch: Callable, generator: torch.Generator,
            reseed: Callable[[int], None]) -> Dict:
        """One update of ``state``: ``step(state, to_batch(inputs),
        generator)`` after ``reseed(state.step)``.  Replays the captured
        step when it was captured for this ``step``, ``to_batch`` and
        ``step.scalars(state.step)``; otherwise runs the update eagerly and
        captures the step for the updates that follow.  Returns the
        update's metrics (device tensors; a replay's are overwritten by the
        next replay)."""
        key = (step, to_batch, step.scalars(state.step))
        if self._graph is None or key != self._key:
            return self._capture(key, step, state, inputs, to_batch, generator, reseed)
        for k, v in inputs.items():
            self._static[k].copy_(v)
        reseed(state.step)
        self._graph.replay()
        for counter, launches in self._launches:
            for k, n in launches.items():
                counter[k] += n
        state.step += 1
        self.replays += 1
        self._replayed = True
        return self._metrics

    def reset(self) -> None:
        """Release the graph and its static tensors."""
        if self._graph is not None:
            self._graph.reset()
        self._graph, self._key, self._static, self._metrics = None, None, {}, {}
        self._launches, self._replayed = (), False

    def _capture(self, key, step, state, inputs, to_batch, generator, reseed):
        with trace.span("graph.capture"):
            old, replayed = self._graph, self._replayed
            self._graph, self._key, self._static, self._metrics = None, None, {}, {}
            device = next(iter(inputs.values())).device
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            make_capturable(state.optimizer)
            with trace.span("graph.drain"):
                torch.cuda.synchronize(device)
            trace.sample(device, phases=old is not None and replayed)
            with trace.span("graph.empty_cache"):
                torch.cuda.empty_cache()
            stream, current = self._stream, torch.cuda.current_stream(device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream), warnings.catch_warnings():
                # capturable Adam warns when it steps outside a capture: the
                # eager update below is meant
                warnings.filterwarnings("ignore", message=".*capturable=True.*")
                static = {k: v.clone() for k, v in inputs.items()}
                reseed(state.step)
                with trace.span("graph.eager_update"), trace.update(device):
                    metrics = step(state, to_batch(static), generator)
                graph = torch.cuda.CUDAGraph()
                graph.register_generator_state(generator)
                n = state.step
                counters = tuple(trace.launch_counters().values())
                before = [dict(c) for c in counters]
                with trace.span("graph.record"):
                    graph.capture_begin(pool=None if old is None else old.pool(),
                                        capture_error_mode="thread_local")
                    try:
                        with trace.update(device):
                            captured = step(state, to_batch(static), generator)
                    finally:
                        graph.capture_end()
                        state.step = n
                # what the wrappers counted in the capture, each replay launches
                self._launches = tuple((c, {k: c[k] - b[k] for k in c if c[k] != b[k]})
                                       for c, b in zip(counters, before) if c != b)
                for c, b in zip(counters, before):
                    c.update(b)
            current.wait_stream(stream)
            if old is not None:
                old.reset()
            self._graph, self._key, self._static, self._metrics = graph, key, static, captured
            self.captures += 1
            self._replayed = False
            return metrics
