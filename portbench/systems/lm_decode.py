"""The LM decode system: ``repro_torch``'s dense decoder, served through
``repro_torch.launch.serve.generate``, judged against the plain float32
reference (``harness/lm_reference.py``).

The weights are the harness's (``lm_reference.make_weights``, seeded from
the model stream) and the program's parameter tree holds them as they
are; the configuration's keys named in :data:`MODEL_KEYS` configure the
program's ``ModelConfig`` (its registered architecture ``arch``, with
those values).  The load generator draws its prompts from the traffic
stream.

The judge compares what the timed path produced:

  * ``tokens_off_margin``: every generated token (warm-up, window and
    traced calls) whose reference logit, at its position of the prompt
    and the tokens served before it, lies more than ``limits.token_gap``
    below that position's reference maximum, plus every token after a
    latched end-of-sequence that is not the pad id; limit 0.
    ``token_gap_max`` is the widest such gap, limit ``limits.token_gap``;
  * ``max_logit_dev``: the warm-up call's logits at every decode step
    (``train/serve_step.decode`` as ``generate`` calls it), the largest
    absolute difference from the reference's; limit
    ``limits.max_logit_dev``;
  * ``steps_compared`` and ``tokens_compared``: at least 1;
    ``calls_failed``: limit 0.

The control (``control.py``) is the reference with every matrix and the
embedding rounded to float8 e4m3 (one scale per tensor), read at the same
prompts and served tokens: its logits' difference on the warm-up call,
and the gap of the token that it puts first at each generated position.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np

from harness import lm_reference
from harness.cell import STREAM_MODEL

__all__ = ["MODEL_KEYS", "Served", "control_checks", "controls", "judge", "make",
           "model_config"]

#: The configuration's keys that the program's ``ModelConfig`` takes.
MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
              "sliding_window", "rope_theta", "norm_eps", "tie_embeddings")
#: A gap or difference that is not finite reads as this (a JSON number, past any limit).
NOT_FINITE = 1e30
#: Sequences the reference runs at a time: its float32 logits of a block
#: at 256 positions over 32,000 ids take 2.1 GB.
BLOCK = 64


class Served(NamedTuple):
    """The system under test: the program's config and parameter tree on
    its device."""

    cfg: Any
    params: Any
    device: Any


def model_config(cfg: Dict):
    import torch

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(cfg["arch"]), **{k: cfg[k] for k in MODEL_KEYS},
                               dtype=getattr(torch, cfg["dtype"]))


def _program_tree(mcfg, weights: Dict):
    """The program's parameter tree (``launch.specs.abstract_model``) with
    each parameter the harness's weight of its name, shared, not copied."""
    from torch import nn

    from repro_torch.launch.specs import abstract_model

    tree = abstract_model(mcfg)
    names = [n for n, _ in tree.named_parameters()]
    if sorted(names) != sorted(weights):
        raise ValueError(f"the program's parameters {sorted(set(names) ^ set(weights))} "
                         "differ from the reference's")
    for name in names:
        mod, _, leaf = name.rpartition(".")
        old, new = getattr(tree.get_submodule(mod), leaf), weights[name]
        if old.shape != new.shape or old.dtype != new.dtype:
            raise ValueError(f"{name}: the program declares {tuple(old.shape)} {old.dtype}, "
                             f"the weights are {tuple(new.shape)} {new.dtype}")
        tree.get_submodule(mod).register_parameter(leaf, nn.Parameter(new, requires_grad=False))
    return tree


def make(cfg: Dict, streams, name: str, device):
    """(engine, pool, inputs): the served model, no pool, and the weights."""
    t = time.perf_counter()
    seed = int(streams[STREAM_MODEL].integers(0, 2**63))
    weights = lm_reference.make_weights(cfg, seed, device)
    mcfg = model_config(cfg)
    served = Served(cfg=mcfg, params=_program_tree(mcfg, weights), device=device)
    print(f"weights and the program's tree: {time.perf_counter() - t:.3f} s", file=sys.stderr,
          flush=True)
    return served, None, {"weights": weights}


def _groups(outcome) -> List[Tuple[np.ndarray, np.ndarray, Any]]:
    """(prompts, tokens, the program's logits or None) of the warm-up call
    and of the other answered calls, those joined by (prompt, generated)
    length."""
    by: Dict[Tuple[int, int], List] = {}
    for prompts, tokens in outcome.answers:
        by.setdefault((prompts.shape[1], tokens.shape[1]), []).append((prompts, tokens))
    warm = outcome.facts["warm"]
    out = [(warm["prompts"], warm["tokens"], warm["logits"])]
    return out + [(np.concatenate([c[0] for c in calls]), np.concatenate([c[1] for c in calls]),
                   None) for _, calls in sorted(by.items())]


def _token_gaps(ref, tokens, p: int, cfg: Dict, pick=None):
    """(gaps, wrong pads) of the ``g`` generated tokens ``[b, g]``: at
    position ``p - 1 + j`` the reference's maximum less its logit of token
    ``j`` (of ``pick``'s argmax where given: the control's), 0 after a
    latched end-of-sequence; and the tokens after it that are not the
    pad id."""
    import torch

    g = tokens.shape[1]
    lg = ref[:, p - 1:p - 1 + g]
    chosen = tokens if pick is None else pick[:, p - 1:p - 1 + g].argmax(-1)
    gap = lg.amax(-1) - lg.gather(-1, chosen[..., None].long())[..., 0]
    eos = (tokens == cfg["eos_id"]).int()
    latched = (eos.cumsum(1) - eos) > 0
    wrong = int((latched & (tokens != cfg["pad_id"])).sum())
    gap = torch.nan_to_num(gap, nan=NOT_FINITE, posinf=NOT_FINITE)
    return torch.where(latched, torch.zeros_like(gap), gap), wrong


def _readings(run, quantize=None, log=None) -> Dict[str, float]:
    """The judge's numbers of the program's answers, or, with ``quantize``,
    the control's, at the same prompts and served tokens."""
    import torch

    cfg, o, dev = run.cfg, run.outcome, run.device
    weights = run.inputs["weights"]
    tau = cfg["limits"]["token_gap"]
    gap_max, off, compared, dev_max, steps = 0.0, 0, 0, 0.0, 0
    t = time.perf_counter()
    for prompts, tokens, mine in _groups(o):
        seqs = torch.from_numpy(np.concatenate([prompts, tokens], 1)).to(dev)
        toks = torch.from_numpy(tokens).to(dev)
        ref = lm_reference.logits_blocks(weights, cfg, seqs, block=BLOCK)
        low = (lm_reference.logits_blocks(weights, cfg, seqs, block=BLOCK, quantize=quantize)
               if quantize is not None else None)
        for r0, lg in ref:
            pick = next(low)[1] if low is not None else None
            gap, wrong = _token_gaps(lg, toks[r0:r0 + BLOCK], prompts.shape[1], cfg, pick)
            gap_max = max(gap_max, float(gap.max()))
            off += int((gap > tau).sum()) + wrong
            compared += gap.numel()
            if mine is not None:
                other = mine[r0:r0 + BLOCK].to(dev) if pick is None else pick
                n = min(other.shape[1], lg.shape[1])
                diff = (other[:, :n] - lg[:, :n]).abs()
                dev_max = max(dev_max, float(torch.nan_to_num(diff, nan=NOT_FINITE,
                                                              posinf=NOT_FINITE).max()))
                steps = n
    if log is not None:
        log(f"reference over {compared} generated tokens: {time.perf_counter() - t:.3f} s")
    return {"tokens_off_margin": off, "token_gap_max": gap_max, "max_logit_dev": dev_max,
            "steps_compared": steps, "tokens_compared": compared}


def _checks(run, r: Dict[str, float]) -> Dict[str, Dict]:
    """The numbers ``r`` read, each with its limit or minimum."""
    lim = run.cfg["limits"]
    return {
        "tokens_off_margin": {"value": r["tokens_off_margin"], "limit": 0},
        "token_gap_max": {"value": r["token_gap_max"], "limit": lim["token_gap"]},
        "max_logit_dev": {"value": r["max_logit_dev"], "limit": lim["max_logit_dev"]},
        "steps_compared": {"value": r["steps_compared"], "min": 1},
        "tokens_compared": {"value": r["tokens_compared"], "min": 1},
        "calls_failed": {"value": run.outcome.failed, "limit": 0},
    }


def judge(run, trace: bool, log) -> Tuple[Dict, Dict]:
    return _checks(run, _readings(run, log=log)), {}


def controls(cfg: Dict) -> List[str]:
    return ["fp8_e4m3"]


def control_checks(run, kind: str) -> Dict[str, Dict]:
    """The judge's checks with the control ``kind`` in the program's place:
    the reference with its weights rounded to float8 e4m3."""
    if kind != "fp8_e4m3":
        raise ValueError(f"no control {kind!r}")
    return _checks(run, _readings(run, quantize=lm_reference.fp8_e4m3))

