"""CUDA graphs of the training step.

On the card one DiffAb training step at batch 16 is some 3350 launches of
small kernels (the loss's forward, autograd's backward, the clip and Adam)
that the host issues one at a time; the device waits on the host for most
of the step. Here the step (:func:`~..parallel.mesh.sharded_train_step`'s,
on one rank) is captured once a batch shape as a CUDA graph and replayed
afterwards: one graph launch a step, the same kernels in the same order.

A graph reads what it read at its capture, at the same addresses: the
parameters, Adam's state and learning rate (a device tensor the trainer
writes in place, so a replay takes the rate in force), and the shape's
static buffers, into which each step copies its batch, ``t`` and ``draws``
(drawn outside the graph, as for the eager step). So the shapes
(:class:`ShapeGraph`) are keyed on the device, the shapes and dtypes of
the batch, ``t`` and the draws, and the parameters' addresses; a trainer
keeps at most :data:`MAX_SHAPES`, dropping the least recently used, and
drops them all when Adam's state is replaced (``load_state_dict``).

A shape's first step runs eagerly on a side stream: a real step, which
also makes Adam's state and the libraries' handles before any capture.
Its second step captures the graph on that stream and replays it; later
steps replay it. What a step returns (the losses and the finite flag) is
cloned out of the graph's outputs, so it belongs to the caller, who may
read step k's values after step k + 1 has been queued.

A graph replays the draws its capture made, so only a step that draws
nothing inside it is captured: the trainer takes this route where
:func:`graphable` holds, and the eager step elsewhere. The K2/K3
wrappers' launch counters count what a replay launches (a capture
launches nothing).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Tuple

import torch

from ..ops.ipa_attention import ipa_attention_bwd, ipa_attention_fwd

# The wrappers whose `launches` count their kernel's launches.
COUNTED = (ipa_attention_fwd, ipa_attention_bwd)
MAX_SHAPES = 4


def graphable(model, device, mesh) -> bool:
    """Whether a trainer's step can be captured: on a CUDA device, on one
    rank with no process group (a collective inside a graph is untried),
    for a model that declares that its loss, given ``t`` and ``draws``,
    draws nothing of its own (``loss_draws_itself`` False)."""
    return (torch.device(device).type == 'cuda' and not mesh.distributed
            and not getattr(model, 'loss_draws_itself', True))


def _signature(tensors: Dict[str, torch.Tensor]) -> tuple:
    return tuple((k, v.shape, v.dtype) for k, v in tensors.items())


class TrainGraphs:
    """A trainer's captured steps, by batch shape: ``step_fn`` is its
    one-rank :func:`~..parallel.mesh.sharded_train_step` over ``model``
    and ``optimizer`` (capturable Adam), on ``device``."""

    def __init__(self, step_fn: Callable, model, optimizer, device):
        self.step_fn, self.optimizer = step_fn, optimizer
        self.params = list(model.parameters())
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._shapes: Dict[tuple, ShapeGraph] = collections.OrderedDict()
        self._state = optimizer.state

    def __len__(self):
        return len(self._shapes)

    def step(self, batch: Dict, t: torch.Tensor,
             draws: Dict) -> Tuple[Dict, str]:
        """One optimizer step on ``batch`` (tensors on the device) with
        ``t`` and ``draws``: (``step_fn``'s losses with their '_finite'
        flag, and what the step did: 'eager' for a shape's first step,
        'capture' or 'replay')."""
        if self.optimizer.state is not self._state:
            self._shapes.clear()
            self._state = self.optimizer.state
        t = t.to(self.device)
        draws = {k: v.to(self.device) for k, v in draws.items()}
        key = (self.device, _signature(batch), t.shape, t.dtype,
               _signature(draws), tuple(p.data_ptr() for p in self.params))
        with torch.cuda.device(self.device):
            shape = self._shapes.pop(key, None)
            if shape is None:
                while len(self._shapes) >= MAX_SHAPES:
                    self._shapes.popitem(last=False)
                self._shapes[key] = ShapeGraph(batch, t, draws)
                return self._warm_up(batch, t, draws), 'eager'
            self._shapes[key] = shape
            mode = 'replay' if shape.graph is not None else 'capture'
            return shape.step(self, batch, t, draws), mode

    def _warm_up(self, batch, t, draws) -> Dict:
        """A shape's first step, eager on the side stream its graph will
        be captured on."""
        main = torch.cuda.current_stream()
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = self.step_fn(batch, t=t, draws=draws)
        main.wait_stream(self.stream)
        return out


class ShapeGraph:
    """The static buffers, the graph and its outputs of one batch shape
    (see the module's docstring)."""

    def __init__(self, batch: Dict, t: torch.Tensor, draws: Dict):
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.t = t.clone()
        self.draws = {k: v.clone() for k, v in draws.items()}
        self.graph = None
        self.keys = None        # the names of the step's outputs, in order
        self.out = None         # their values, one float32 vector
        self.launches = None    # what a replay adds to each COUNTED wrapper

    def step(self, owner: TrainGraphs, batch, t, draws) -> Dict:
        """Copy the step's inputs in, replay the graph (captured first if
        there is none) and return a clone of its outputs."""
        for k, buf in self.batch.items():
            buf.copy_(batch[k])
        self.t.copy_(t)
        for k, buf in self.draws.items():
            buf.copy_(draws[k])
        if self.graph is None:
            self._capture(owner)
        self.graph.replay()
        for wrapper, n in zip(COUNTED, self.launches):
            wrapper.launches += n
        return dict(zip(self.keys, self.out.clone().unbind()))

    def _capture(self, owner: TrainGraphs):
        """The graph of ``owner.step_fn`` on the static buffers, captured
        on the owner's side stream into a memory pool of its own, ending
        in one vector of the step's outputs. Nothing runs yet, so the
        wrappers' counts go back to what they were."""
        graph = torch.cuda.CUDAGraph()
        before = [w.launches for w in COUNTED]
        owner.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(owner.stream):
            graph.capture_begin(capture_error_mode='thread_local')
            try:
                out = owner.step_fn(self.batch, t=self.t, draws=self.draws)
                self.keys = list(out)
                self.out = torch.stack([v.float() for v in out.values()])
            finally:
                graph.capture_end()
        self.launches = [w.launches - n for w, n in zip(COUNTED, before)]
        for w, n in zip(COUNTED, before):
            w.launches = n
        self.graph = graph
