"""AdamW with float32 master weights and the cosine schedule: the port's copy
of ``repro/train/optimizer.py``.

Not ``torch.optim.AdamW``: that keeps no float32 master, applies the
weight decay in another order and knows neither this schedule nor the
clip.  The moments and the masters are dicts of float32 tensors keyed by
the model's ``named_parameters()`` names, on the parameters' devices.
The step's scalars (the schedule, the clip scale, the bias corrections)
are float32 tensors on the device, so an update makes no host sync.

The update writes the parameters, the moments and the masters in place:
a full-width model's float32 state is three times its bfloat16 weights
over again, and a second copy of it would not fit beside the first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping, Tuple

import torch

from repro_torch.configs.base import TrainConfig

__all__ = ["OptState", "adamw_leaf", "adamw_scalars", "adamw_update", "global_norm",
           "init_opt_state", "lr_schedule"]


@dataclasses.dataclass
class OptState:
    step: torch.Tensor                 # int32 scalar
    m: Dict[str, torch.Tensor]         # float32, like the parameters
    v: Dict[str, torch.Tensor]         # float32, like the parameters
    master: Dict[str, torch.Tensor]    # float32 master weights


def _named(params) -> Iterable[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of a module's parameters or of a name -> tensor map."""
    if isinstance(params, torch.nn.Module):
        return params.named_parameters()
    return params.items()


@torch.no_grad()
def init_opt_state(params) -> OptState:
    """Zero moments and a float32 *copy* of each parameter as its master
    (a float32 parameter must not alias its master)."""
    named = list(_named(params))
    device = named[0][1].device if named else None
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in named},
        v={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in named},
        master={n: p.detach().to(torch.float32, copy=True) for n, p in named},
    )


def lr_schedule(step: torch.Tensor, tcfg: TrainConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to 10% of peak; float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(tcfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - tcfg.warmup_steps) / max(tcfg.total_steps - tcfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.55 + 0.45 * torch.cos(math.pi * prog)
    return tcfg.learning_rate * warm * cos


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor of ``tree`` (a name ->
    tensor map or a sequence of tensors), in float32, summed leaf by leaf
    in order."""
    leaves = tree.values() if isinstance(tree, Mapping) else tree
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32))) for leaf in leaves))


def adamw_scalars(step: torch.Tensor, gnorm: torch.Tensor, tcfg: TrainConfig):
    """The step's scalars from its number and the gradient's norm: (clip
    scale, learning rate, the two bias corrections), float32 on the
    step's device."""
    scale = torch.clamp(tcfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(step, tcfg)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(tcfg.beta1, stepf)
    bc2 = 1.0 - torch.pow(tcfg.beta2, stepf)
    return scale, lr, bc1, bc2


@torch.no_grad()
def adamw_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
               mw: torch.Tensor, scalars, tcfg: TrainConfig) -> None:
    """One tensor's AdamW update in place (parameter, moments, master),
    elementwise, so a block of a tensor updates as the tensor would."""
    scale, lr, bc1, bc2 = scalars
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    g = g.to(torch.float32) * scale
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    mhat = m / bc1
    vhat = v / bc2
    mw.sub_(lr * (mhat / (torch.sqrt(vhat) + eps) + wd * mw))
    p.copy_(mw)


@torch.no_grad()
def adamw_update(params, grads: Mapping[str, torch.Tensor], opt: OptState,
                 tcfg: TrainConfig) -> Tuple[object, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step (gradient clip, then decoupled weight decay against
    the master).  ``params`` is a module or a name -> tensor map; ``grads``
    maps the same names.  Writes the parameters and ``opt``'s tensors in
    place and returns ``(params, opt with the next step, {grad_norm, lr})``."""
    step = opt.step + 1
    gnorm = global_norm(grads)
    scalars = adamw_scalars(step, gnorm, tcfg)
    for name, p in _named(params):
        adamw_leaf(p, grads[name], opt.m[name], opt.v[name], opt.master[name], scalars, tcfg)
    opt = dataclasses.replace(opt, step=step)
    return params, opt, {"grad_norm": gnorm, "lr": scalars[1]}
