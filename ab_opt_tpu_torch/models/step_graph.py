"""CUDA graphs of DiffAb's reverse step, on :mod:`..utils.cuda_graph`.

One reverse step of :class:`~.diffab.DiffAb` is some 430 launches (the
denoiser's input glue, the encoder's six K1 layers, the heads, the rotation
algebra, the three transitions). The graphs are grouped by request shape
(:class:`ShapeGraphs`), keyed on what they bake in: the device, N, L, reps,
the encoder route, the compute dtype, ``obj``, the two sample flags and the
addresses of the model's parameters and IGSO3 table (read in place, so an
update in place is seen). A shape's static buffers hold the request's
features, masks and denoiser operands (copied in once a call, so new
weights need no new capture), the state and the noise (once a step). Each
level ``(t, t_next)`` has its graph, since the transitions bake the level
into Python floats and branches; a shape's graphs share one memory pool
and output buffers. A shape's first call captures every level, each step
capturing the next level's while the device runs its own: that hides the
captures where the device sets the pace (a large fan-out) and costs up to
about one eager call where the host does. Later calls replay them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..utils.cuda_graph import Graph, ShapeCache, clone, load

# The encoder routes whose step is captured: K1's layers and the eager
# GAEncoder over K4. K5 stays eager (see DiffAb._reverse_loop).
GRAPH_ROUTES = ('k1', 'k4')


def _next_level(t: int, t_next: Optional[int]):
    """The level the reverse loop steps from after (t, t_next): t - 1 on
    an ancestral step, else the same stride on; None after the last."""
    if t_next is None:
        return (t - 1, None) if t > 1 else None
    return (t_next, max(2 * t_next - t, 0)) if t_next > 0 else None


class StepGraphs(ShapeCache):
    """A model's captured reverse steps, by request shape. A copy or a
    pickle of the model starts with none."""

    def bind(self, model, route: str, operands: dict, res_feat,
             mask_generate, mask_res, state, reps: int,
             flags: Tuple[bool, bool]) -> 'ShapeGraphs':
        """The shape of one sampling call, holding its ``res_feat``, masks
        and ``operands`` (:meth:`DiffAb.denoiser_operands` of ``route``);
        ``state`` is its initial (v, p, s), ``flags`` (sample_structure,
        sample_sequence)."""
        N, L = mask_res.shape
        addresses = (tuple(p.data_ptr() for p in model.parameters())
                     + (model.trans_rot.igso3_inv.cdf.data_ptr(),))
        key = (res_feat.device, N, L, reps, route, model.cfg.compute_dtype,
               model.cfg.obj, flags, addresses)
        inputs = (operands, res_feat, mask_generate, mask_res)
        shape, made = self.get_or_make(key, lambda: ShapeGraphs(
            model, route, inputs, state, reps, flags))
        if not made:
            load(shape.inputs, inputs)
        return shape


class ShapeGraphs:
    """The static buffers, the memory pool and the per-level graphs of one
    request shape (see the module's docstring)."""

    def __init__(self, model, route, inputs, state, reps, flags):
        self.inputs = clone(inputs)
        operands, res_feat, _, mask_res = self.inputs
        self.device = res_feat.device
        self.denoiser = model.denoiser_from(route, operands, reps)
        self.state = clone(state)
        N, L = mask_res.shape
        empty = lambda *dims: torch.empty(dims, device=self.device)
        self.noise = {'rot_axis': empty(N, L, 3), 'rot_u': empty(N, L),
                      'rot_frac': empty(N, L), 'rot_gauss': empty(N, L),
                      'pos': empty(N, L, 3),
                      'seq_gumbel': empty(N, L, model.trans_seq.num_classes)}
        self.reps, self.flags = reps, flags
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.graphs: Dict[Tuple[int, Optional[int]], Graph] = {}
        self.out = None     # the outputs every level's graph writes

    def mode(self, t: int, t_next: Optional[int]) -> str:
        """'capture' if the step at this level captures its graph or the
        next level's (:meth:`step`), else 'replay'."""
        nxt = _next_level(t, t_next)
        new = (t, t_next) not in self.graphs or (
            nxt is not None and nxt not in self.graphs)
        return 'capture' if new else 'replay'

    def step(self, model, v, p, s, t: int, t_next: Optional[int],
             noise: dict):
        """:meth:`DiffAb.reverse_step`'s outputs at level (t, t_next) from
        (v, p, s) with the step's ``noise`` (:meth:`DiffAb.step_noise`),
        by the level's graph (captured first if it has none); then, while
        the device runs it, the next level's graph is captured."""
        load((self.state, self.noise), ((v, p, s), noise))
        graph = self.graphs.get((t, t_next)) or self._capture(model, t, t_next)
        with torch.cuda.device(self.device):
            graph.replay()
        out = clone(self.out)
        nxt = _next_level(t, t_next)
        if nxt is not None and nxt not in self.graphs:
            self._capture(model, *nxt)
        return out

    def _capture(self, model, t: int, t_next: Optional[int]) -> Graph:
        """The level's graph, ending in a copy of the step's outputs to
        ``self.out`` (made at the first capture, kept in the pool)."""
        _, res_feat, mask_generate, mask_res = self.inputs

        def body():
            out = model.step_body(
                *self.state, t, res_feat, mask_generate, mask_res,
                self.denoiser, self.reps, self.noise, None, *self.flags,
                t_next)
            if self.out is None:
                self.out = tuple(torch.empty_like(x) for x in out)
            load(self.out, out)

        graph = self.graphs[(t, t_next)] = Graph(body, self.stream, self.pool)
        return graph
