"""CUDA graphs of DiffAb's reverse step.

On the card one reverse step of :class:`~.diffab.DiffAb` is some 430
launches of small kernels (the denoiser's input glue, the encoder's six K1
layers, the heads, the rotation algebra and the three transitions) that
the host issues one at a time; at a small batch the device waits on the
host for most of the step. Here each step is captured once as a CUDA
graph and replayed afterwards: one graph launch a step, the same kernels
in the same order.

A graph bakes in the addresses of what it reads and every Python value the
step branches on. So the graphs are grouped by request shape
(:class:`ShapeGraphs`), keyed on the device, N, L, reps, the encoder route,
the compute dtype, ``obj``, the two sample flags and the addresses of the
model's parameters and IGSO3 table (which the graphs read in place, so an
update in place is seen and a moved tensor makes a new shape). A shape
owns static buffers for everything its graphs read: the request's
features and masks and the denoiser's step-invariant operands (copied in
once a call, so new weights are picked up without a new capture), the
state and the step's noise (copied in once a step; the noise is drawn
outside the graph). Each level ``(t, t_next)`` has its graph, since the
transitions bake the level into Python floats and branches; the graphs of
a shape share one memory pool and run one after another, in loop order,
each ending in a copy of its outputs to buffers they share. What a step
returns is cloned out of those, so it belongs to the caller.

The first call of a shape captures every level, each step capturing the
next level's graph on the host while the device runs its own: where the
device sets the pace (a large fan-out) that hides the captures, and where
the host does they cost up to about one eager call. A caller that fans one
shape out over many calls replays them. A model keeps at most
:data:`MAX_SHAPES` shapes, dropping the least recently used.
The K1 and K4 wrappers' launch counters count what a replay launches (a
capture launches nothing).
"""
from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import torch

from ..ops.gablock import gablock_layer
from ..ops.ipa_attention import ipa_attention_fwd_p2n

# The encoder routes whose step is captured: K1's layers and the eager
# GAEncoder over K4. K5 stays eager (see DiffAb._reverse_loop).
GRAPH_ROUTES = ('k1', 'k4')
# Their wrappers, whose `launches` count the kernel's launches.
COUNTED = (gablock_layer, ipa_attention_fwd_p2n)
MAX_SHAPES = 4


def _tensors(tree):
    """The tensors of a nest of dicts, lists and tuples, in order."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)


def _clone(tree):
    """``tree`` with every tensor cloned (anything else kept as is)."""
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(x) for k, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(x) for x in tree)
    return tree


def _next_level(t: int, t_next: Optional[int]):
    """The level the reverse loop steps from after (t, t_next): t - 1 on
    an ancestral step, else the same stride on; None after the last."""
    if t_next is None:
        return (t - 1, None) if t > 1 else None
    return (t_next, max(2 * t_next - t, 0)) if t_next > 0 else None


def _addresses(model) -> Tuple[int, ...]:
    return (tuple(p.data_ptr() for p in model.parameters())
            + (model.trans_rot.igso3_inv.cdf.data_ptr(),))


class StepGraphs:
    """A model's captured reverse steps, by request shape. A copy or a
    pickle of the model starts with none."""

    def __init__(self):
        self._shapes: Dict[tuple, ShapeGraphs] = collections.OrderedDict()

    def __reduce__(self):
        return StepGraphs, ()

    def __len__(self):
        return len(self._shapes)

    def bind(self, model, route: str, operands: dict, res_feat,
             mask_generate, mask_res, state, reps: int,
             flags: Tuple[bool, bool]) -> 'ShapeGraphs':
        """The shape of one sampling call, holding this call's
        ``res_feat``, masks and denoiser ``operands``
        (:meth:`DiffAb.denoiser_operands` of ``route``); ``state`` is the
        call's initial (v, p, s), ``flags`` (sample_structure,
        sample_sequence)."""
        N, L = mask_res.shape
        cfg = model.cfg
        key = (res_feat.device, N, L, reps, route, cfg.compute_dtype,
               cfg.obj, flags, _addresses(model))
        shape = self._shapes.pop(key, None)
        if shape is None:
            shape = ShapeGraphs(model, route, operands, res_feat,
                                mask_generate, mask_res, state, reps, flags)
            while len(self._shapes) >= MAX_SHAPES:
                self._shapes.popitem(last=False)
        else:
            shape.load((operands, res_feat, mask_generate, mask_res))
        self._shapes[key] = shape
        return shape


class ShapeGraphs:
    """The static buffers, the memory pool and the per-level graphs of one
    request shape (see the module's docstring)."""

    def __init__(self, model, route, operands, res_feat, mask_generate,
                 mask_res, state, reps, flags):
        self.device = res_feat.device
        self.operands, self.res_feat, self.mask_generate, self.mask_res = (
            _clone((operands, res_feat, mask_generate, mask_res)))
        self.denoiser = model.denoiser_from(route, self.operands, reps)
        self.state = [x.clone() for x in state]
        N, L = mask_res.shape
        empty = lambda *dims: torch.empty(dims, device=self.device)
        self.noise = {'rot_axis': empty(N, L, 3), 'rot_u': empty(N, L),
                      'rot_frac': empty(N, L), 'rot_gauss': empty(N, L),
                      'pos': empty(N, L, 3),
                      'seq_gumbel': empty(N, L, model.trans_seq.num_classes)}
        self.reps, self.flags = reps, flags
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        # (t, t_next) -> (graph, its launches of each COUNTED wrapper)
        self.graphs: Dict[Tuple[int, Optional[int]], tuple] = {}
        self.out = None     # the outputs every level's graph writes

    def load(self, inputs):
        """Copy a call's (operands, res_feat, mask_generate, mask_res) into
        the static buffers."""
        mine = (self.operands, self.res_feat, self.mask_generate,
                self.mask_res)
        for dst, src in zip(_tensors(mine), _tensors(inputs), strict=True):
            dst.copy_(src)

    def mode(self, t: int, t_next: Optional[int]) -> str:
        """What the step at this level will do: 'capture' when it captures
        its level's graph or the next level's (:meth:`step`), else
        'replay'."""
        nxt = _next_level(t, t_next)
        new = (t, t_next) not in self.graphs or (
            nxt is not None and nxt not in self.graphs)
        return 'capture' if new else 'replay'

    def step(self, model, v, p, s, t: int, t_next: Optional[int],
             noise: dict):
        """One reverse step at level (t, t_next) from state (v, p, s) with
        the step's ``noise`` (:meth:`DiffAb.step_noise`): copies them in,
        replays the level's graph (captured first if it has none) and
        returns clones of :meth:`DiffAb.reverse_step`'s outputs. While the
        device runs the step, the host captures the next level's graph if
        it has none, so that a shape's first call pays little more than
        the device's time where the device sets the pace."""
        for dst, src in zip(self.state, (v, p, s)):
            dst.copy_(src)
        for k, buf in self.noise.items():
            if k in noise:
                buf.copy_(noise[k])
        entry = self.graphs.get((t, t_next))
        if entry is None:
            entry = self.graphs[(t, t_next)] = self._capture(model, t, t_next)
        graph, launches = entry
        with torch.cuda.device(self.device):
            graph.replay()
        for wrapper, n in zip(COUNTED, launches):
            wrapper.launches += n
        out = tuple(x.clone() for x in self.out)
        nxt = _next_level(t, t_next)
        if nxt is not None and nxt not in self.graphs:
            self.graphs[nxt] = self._capture(model, *nxt)
        return out

    def _capture(self, model, t: int, t_next: Optional[int]):
        """(graph, launches): the graph of the step at (t, t_next),
        captured on the shape's stream into its pool, ending in a copy of
        the step's outputs to ``self.out`` (made at the first capture, kept
        in the pool): no other memory outlives a step. Nothing runs yet, so
        the wrappers' counts go back to what they were, and ``launches``
        holds what each replay adds."""
        graph = torch.cuda.CUDAGraph()
        v, p, s = self.state
        before = [w.launches for w in COUNTED]
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool,
                                capture_error_mode='thread_local')
            try:
                out = model.step_body(
                    v, p, s, t, self.res_feat, self.mask_generate,
                    self.mask_res, self.denoiser, self.reps, self.noise,
                    None, *self.flags, t_next)
                if self.out is None:
                    self.out = [torch.empty_like(x) for x in out]
                for dst, x in zip(self.out, out):
                    dst.copy_(x)
            finally:
                graph.capture_end()
        launches = [w.launches - n for w, n in zip(COUNTED, before)]
        for w, n in zip(COUNTED, before):
            w.launches = n
        return graph, launches
