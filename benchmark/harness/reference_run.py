"""Running the plain reference: the model built from a configuration in
float32 with the benchmark's weights, the lower precision of a control,
the gaps of a sampling check, and three training steps with a plain
Adam."""
from __future__ import annotations

import math

import numpy as np
import torch

FP8_MAX = 448.0            # the largest float8 e4m3 number


def _fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _RoundFP8(torch.autograd.Function):
    """float8 e4m3 both ways: the value forward, its gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude onto 448), back in float32, and so its gradient: the control
    of a bfloat16 configuration."""
    return _RoundFP8.apply(x)


def reference_model(cls, model_cfg: dict, weights: dict, device,
                    rounding=None):
    """``cls`` (the reference's DiffAb or DiffGNN) of ``model_cfg`` in
    float32, with ``weights``; ``rounding`` rounds every Linear's operands
    and output, and the attention's operands, alphas and outputs."""
    from reference.models import DiffAbConfig, DiffGNNConfig
    from reference.nn import GABlock, Linear
    from .weights import load_state
    cfg = dict(model_cfg, dtype='float32')
    cfg_cls = DiffAbConfig if cls.__name__ == 'DiffAb' else DiffGNNConfig
    model = cls(cfg_cls.from_dict(cfg)).to(device)
    load_state(model, weights)
    model.eval()
    for m in model.modules():
        if isinstance(m, (Linear, GABlock)):
            m.operand_rounding = rounding
    return model


class Gaps:
    """The numbers of a sampling check, over the trajectories it reads."""

    # A context value that moved by more than this from the initial state
    # counts as changed (the program keeps the context bit for bit; the
    # reference's initial state is the same arithmetic).
    CONTEXT_TOL = 1e-4

    def __init__(self):
        self.atoms = self.margin = 0.0
        self.changed = 0
        self.pos, self.rot, self.eps = [], [], []

    def first_step(self, ref, got, want, gen):
        """``got`` and ``want``: (v, p normalized, s, ...) after the first
        reverse step; ``gen`` the generated residues. The gaps of their
        positions (A) and rotations (Frobenius)."""
        from reference.geometry import so3vec_to_rotation
        dp = (ref.unnormalize_position(got[1])
              - ref.unnormalize_position(want[1]))
        self.pos.append(dp.norm(dim=-1)[gen].float().cpu())
        dR = torch.linalg.matrix_norm(so3vec_to_rotation(got[0].float())
                                      - so3vec_to_rotation(want[0].float()))
        self.rot.append(dR[gen].float().cpu())

    def later_step(self, p_got, p_want, gen, sched, t: int):
        """The positions (normalized) after the reverse step at level t:
        the median over the generated residues of their gap over the
        factor by which the step scales the predicted noise, i.e. the gap
        in the noise prediction that the step implies."""
        alpha = max(float(sched.alphas[t]), float(sched.alphas[-2]))
        coef = (1.0 - alpha) / math.sqrt(
            (1.0 - float(sched.alpha_bars[t]) + 1e-8) * (alpha + 1e-8))
        d = (p_got.float() - p_want.float()).norm(dim=-1)[gen]
        self.eps.append(float(d.median()) / coef)

    def sequence(self, s_got, post, gumbel, gen):
        """How far the program's tokens ``s_got`` lie below the best score
        of the reference's step, log posterior ``post`` plus the step's
        Gumbel draw (0 where they are its choice), widest over ``gen``; a
        token outside the posterior's classes reads infinity."""
        score = torch.log(post.float() + 1e-8) + gumbel.float()
        K = score.shape[-1]
        tok = s_got.long()
        mine = score.gather(-1, tok.clamp(0, K - 1)[..., None])[..., 0]
        gap = torch.where((tok >= 0) & (tok < K), score.amax(-1) - mine,
                          torch.full_like(mine, math.inf))[gen]
        if gap.numel():
            self.margin = max(self.margin, float(gap.max()))

    def context(self, x, x0, ctx):
        """Context values of every step (steps, rows, L, ...) that moved
        from the initial state's ``x0`` (rows, L, ...); ``ctx`` (rows, L)
        marks the context residues."""
        d = np.abs(np.asarray(x, np.float64) - np.asarray(x0, np.float64))
        d = d.reshape(d.shape[:3] + (-1,)).max(-1)
        self.changed += int(((d > self.CONTEXT_TOL) & ctx[None]).sum())

    def backbone(self, pos_got, mask_got, pos_ref, mask_ref):
        """The rebuilt backbone: the widest gap (A) over the atoms either
        side places; an atom placed on one side only reads 1e9."""
        if bool((mask_got != mask_ref).any()):
            self.atoms = 1e9
            return
        d = (pos_got.float() - pos_ref.float()).abs().amax(-1)
        self.atoms = max(self.atoms, float((d * mask_ref).amax()))

    def numbers(self) -> dict:
        cat = lambda xs: torch.cat(xs).double() if xs else torch.zeros(1)
        pos, rot = cat(self.pos), cat(self.rot)
        return {'first_pos_gap_rms_A': float(pos.square().mean().sqrt()),
                'first_rot_gap_median': float(rot.median()),
                'step_eps_gap': max(self.eps, default=0.0),
                'seq_margin': self.margin,
                'context_changed': float(self.changed),
                'backbone_gap_A': self.atoms}


# ------------------------------------------------------------------ training

def leaf_gaps(got: dict, want: dict, keep=None) -> np.ndarray:
    """Each leaf's gap between two norms a leaf, against the reference's
    norm of that leaf or of the median leaf, whichever is larger.
    ``keep``: the leaves compared (default all)."""
    names = [n for n in want if keep is None or n in keep]
    med = float(np.median([want[n] for n in names])) if names else 0.0
    return np.array([abs(got.get(n, 0.0) - want[n])
                     / max(want[n], med, 1e-30) for n in names] or [0.0])


def train_reference(model, batches, draws, dropout_gens, loss_weights,
                    max_grad_norm, opt, moments=None):
    """Three (or len(batches)) steps of the reference from its weights:
    the weighted loss, the gradients clipped to their global norm, Adam
    from ``moments`` (first and second moments and step count a leaf;
    default zeros, step 0). Returns (losses, first clipped gradient norms
    a leaf, the norms a leaf of the parameters' change)."""
    lr, b1, b2 = float(opt['lr']), float(opt['beta1']), float(opt['beta2'])
    eps = 1e-8
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    if moments is None:
        m = {n: torch.zeros_like(p) for n, p in params.items()}
        v = {n: torch.zeros_like(p) for n, p in params.items()}
        step0 = {n: 0.0 for n in params}
    else:
        m = {n: moments[0][n].clone().float() for n in params}
        v = {n: moments[1][n].clone().float() for n in params}
        step0 = moments[2]
    losses, first = [], None
    for k, (batch, (t, d), gen) in enumerate(zip(batches, draws,
                                                 dropout_gens)):
        out = model.loss(batch, generator=gen, t=t, draws=d)
        total = sum(out[n] * float(w) for n, w in loss_weights.items()
                    if n in out)
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g)
                 for (n, p), g in zip(params.items(), grads)}
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads.values()))
        coef = max_grad_norm / (norm + 1e-6)
        if coef < 1.0:
            grads = {n: g * coef for n, g in grads.items()}
        if first is None:
            first = {n: float(g.norm()) for n, g in grads.items()}
        losses.append(float(total.detach()))
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n]
                i = step0[n] + k + 1
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[n] / (1 - b1 ** i)
                vh = v[n] / (1 - b2 ** i)
                p.sub_(lr * mh / (vh.sqrt() + eps))
    change = {n: float((p.detach() - start[n]).norm())
              for n, p in params.items()}
    return losses, first, change
