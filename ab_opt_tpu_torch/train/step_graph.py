"""CUDA graphs of the training step, on :mod:`..utils.cuda_graph`.

One DiffAb training step at batch 16 is some 3350 launches (the loss's
forward, autograd's backward, the clip and Adam). The graph of a step
(:func:`~..parallel.mesh.sharded_train_step`'s, on one rank) reads the
parameters, Adam's state and learning rate (a device tensor the trainer
writes in place, so a replay takes the rate in force) and the static
buffers of its batch, ``t`` and ``draws`` (drawn outside the graph, as for
the eager step). So there is one graph a batch shape, keyed on the device,
the shapes and dtypes of those inputs and the parameters' addresses, all
dropped when Adam's state is replaced (``load_state_dict``). A shape's
first step runs eagerly on a side stream (a real step, which makes Adam's
state and the libraries' handles), its second captures the graph there and
replays it, later steps replay it. A step returns the losses and the finite
flag cloned out of the graph's one float32 vector of outputs, so the
caller may read step k's values after step k + 1 has been queued.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..utils.cuda_graph import Graph, ShapeCache, clone, load


def graphable(model, device, mesh) -> bool:
    """Whether a trainer's step can be captured: on a CUDA device, on one
    rank with no process group, for a model whose ``loss_draws_itself``
    is False (its loss draws nothing given ``t`` and ``draws``)."""
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
        self._shapes = ShapeCache()
        self._state = optimizer.state

    def __len__(self):
        return len(self._shapes)

    def step(self, batch: Dict, t: torch.Tensor,
             draws: Dict) -> Tuple[Dict, str]:
        """One optimizer step on ``batch`` (on the device), ``t`` and
        ``draws``: (``step_fn``'s losses and '_finite' flag, and what the
        step did: 'eager' at a shape's first step, 'capture' or 'replay')."""
        if self.optimizer.state is not self._state:
            self._shapes.clear()
            self._state = self.optimizer.state
        t = t.to(self.device)
        draws = {k: v.to(self.device) for k, v in draws.items()}
        key = (self.device, _signature(batch), t.shape, t.dtype,
               _signature(draws), tuple(p.data_ptr() for p in self.params))
        with torch.cuda.device(self.device):
            # A shape's static (batch, t, draws) and its graph.
            shape, made = self._shapes.get_or_make(
                key, lambda: [clone((batch, t, draws)), None])
            main = torch.cuda.current_stream()
            if made:
                self.stream.wait_stream(main)
                with torch.cuda.stream(self.stream):
                    out = self.step_fn(batch, t=t, draws=draws)
                main.wait_stream(self.stream)
                return out, 'eager'
            inputs, graph = shape
            load(inputs, (batch, t, draws))
            if graph is None:
                self.stream.wait_stream(main)
                shape[1] = Graph(lambda: self._body(*inputs), self.stream)
            shape[1].replay()
            keys, out = shape[1].out
            return (dict(zip(keys, clone(out).unbind())),
                    'replay' if graph is not None else 'capture')

    def _body(self, batch, t, draws):
        """The captured step: ``step_fn`` on a shape's static buffers,
        its outputs' names and their values stacked in one vector."""
        out = self.step_fn(batch, t=t, draws=draws)
        return list(out), torch.stack([v.float() for v in out.values()])
