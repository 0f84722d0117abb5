"""The latent-attention MoE decode system: ``repro_torch``'s DeepSeek-V3
block (Moonlight-16B-A3B), served through
``repro_torch.launch.serve.generate``, judged against the plain float32
reference (``harness/mla_moe_reference.py``).

The configuration is the model's own ``config.json`` keys; they configure
the program's registered architecture ``arch`` (:func:`model_config`).
The weights are the harness's (``mla_moe_reference.make_weights``, seeded
from the model stream) and the program's parameter tree holds them as
they are (``lm_decode``'s tree, shared, not copied).  ``make`` arms the
program's routing recorder (``repro_torch.models.moe.ROUTING``) for
``route_steps`` decode steps, the warm-up call's and the window's first
call's, so the judge sees the experts the program chose there (it keeps
references, ~80 MB at 256 sequences of 128 + 128, and copies nothing),
and for the group counts of the traced call.  The load generator is
``lm_generate``.

The sigmoid router picks whole experts.  Where a token's ``k``-th and
``k+1``-th biased scores nearly tie at some layer, a float32 reference
routes it other than a bf16 program does, and the two then differ by an
expert's output; on random weights nearly every position has such a tie
at one of its 26 MoE layers, so a per-token comparison with the plain
reference alone cannot tell rounding from a fault.  The judge holds each
part of the result to what it should be, in the **routing-forced**
reference, which takes the program's experts at each (position, layer) of
a recorded call and its own float32 scores for their weights:

  * ``route_depth_max``: on both recorded calls, how far below that
    layer's ``k``-th biased score the lowest expert the program chose
    lies, the largest over every position and layer; limit
    ``limits.route_delta`` (every choice the program made is one a float32
    router makes or nearly makes);
  * ``max_logit_dev``: the warm-up call's logits at every decode step
    against the forced reference; limit ``limits.max_logit_dev``;
  * ``tokens_off_margin`` and ``token_gap_max``: every generated token of
    both recorded calls (the window's first at the window's positions)
    against the forced reference: each token's reference logit below that
    position's reference maximum (limit ``limits.token_gap``; the count
    past it, limit 0), plus every token of any call after a latched
    end-of-sequence that is not the pad id;
  * ``token_gap_mean``: every generated token (warm-up, window and traced
    calls) against the plain reference routing by itself: the mean gap,
    limit ``limits.token_gap_mean``, a second check over the calls the
    recorder did not see;
  * ``steps_compared``, ``forced_tokens_compared`` and ``tokens_compared``
    at least 1, ``calls_failed`` limit 0.

The control (``control.py``) is the reference with every matrix, the
router and the embedding rounded to float8 e4m3 (one scale per tensor) in
the program's place: forced to the program's experts for its logits, its
own choices along that path for the depth, and the token it puts first
at each generated position for the gaps.  The log line gives the share
of generated positions with a routing near-tie (within
``limits.route_delta``) at some layer.
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from harness import mla_moe_reference as ref_mod
from harness.cell import STREAM_MODEL, _module

__all__ = ["control_checks", "controls", "judge", "make", "model_config"]

_lm = _module(Path(__file__).with_name("lm_decode.py"))
Served, NOT_FINITE = _lm.Served, _lm.NOT_FINITE
#: Sequences the reference's layers run at a time, and its head: the
#: float32 logits of 8 sequences at 256 positions over 163,840 ids take 1.3 GB.
BLOCK, HEAD_BLOCK = 64, 8


def model_config(cfg: Dict):
    """The program's ``ModelConfig`` of the configuration (its registered
    ``arch`` with the configuration's values): raises at once where the
    program has no such arch or the configuration asks for what it lacks."""
    import torch

    from repro_torch.configs import get_config

    fixed = {"q_lora_rank": None, "n_group": 1, "topk_group": 1, "scoring_func": "sigmoid",
             "topk_method": "noaux_tc", "norm_topk_prob": True, "hidden_act": "silu",
             "attention_bias": False, "num_nextn_predict_layers": 0, "moe_layer_freq": 1}
    odd = {k: cfg.get(k) for k, v in fixed.items() if cfg.get(k) != v}
    if odd:
        raise ValueError(f"the program does not take {odd}")
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    return dataclasses.replace(
        get_config(cfg["arch"]),
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["moe_intermediate_size"], vocab_size=cfg["vocab_size"], head_dim=nope + rope,
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=nope, qk_rope_head_dim=rope,
        v_head_dim=cfg["v_head_dim"], n_experts=cfg["n_routed_experts"],
        n_experts_per_token=cfg["num_experts_per_tok"], n_shared_experts=cfg["n_shared_experts"],
        d_ff_shared=cfg["moe_intermediate_size"] * cfg["n_shared_experts"],
        first_k_dense=cfg["first_k_dense_replace"], d_ff_dense=cfg["intermediate_size"],
        routed_scaling=cfg["routed_scaling_factor"], tie_embeddings=cfg["tie_word_embeddings"],
        dtype=getattr(torch, cfg["torch_dtype"]))


def make(cfg: Dict, streams, name: str, device):
    """(engine, pool, inputs): the served model, no pool, and the weights."""
    from repro_torch.models.moe import ROUTING

    mcfg = model_config(cfg)
    t = time.perf_counter()
    seed = int(streams[STREAM_MODEL].integers(0, 2**63))
    weights = ref_mod.make_weights(cfg, seed, device)
    served = Served(cfg=mcfg, params=_lm._program_tree(mcfg, weights), device=device)
    ROUTING.arm(int(cfg["route_steps"]))
    ROUTING.arm_counts()
    print(f"weights and the program's tree: {time.perf_counter() - t:.3f} s", file=sys.stderr,
          flush=True)
    return served, None, {"weights": weights}


class _Call(NamedTuple):
    """A call the routing recorder saw: its prompts and generated tokens
    (``[b, p]``, ``[b, g]``), the program's logits of each decode step
    (``[b, p + g, V]``, the warm-up's) or None, and the experts the program
    chose at each step, by layer (``[b, p + g, k]`` on the device)."""

    prompts: np.ndarray
    tokens: np.ndarray
    logits: Any
    chosen: Dict[int, Any]


def _recorded(run) -> List[_Call]:
    """The calls the recorder was armed for: the warm-up call and, where no
    call failed, the window's first (taken from the recorder once, kept in
    the inputs).  Raises where the configuration's ``route_steps`` is not
    the two calls' decode steps, or the recorder kept other than those."""
    import torch

    from repro_torch.models.moe import ROUTING

    if "recorded" in run.inputs:
        return run.inputs["recorded"]
    o = run.outcome
    warm = o.facts["warm"]
    _, p, g = o.facts["call_shape"]
    n_warm = warm["prompts"].shape[1] + warm["tokens"].shape[1]
    want = int(run.cfg["route_steps"])
    if want != n_warm + p + g:
        raise ValueError(f"route_steps {want} is not the warm-up's {n_warm} decode steps and "
                         f"a window call's {p + g}")
    steps = ROUTING.take_chosen()
    if len(steps) != want and not o.failed:
        raise RuntimeError(f"the recorder kept {len(steps)} decode steps, not {want}")

    def by_layer(part) -> Dict[int, Any]:
        by: Dict[int, List] = {}
        for step in part:
            for layer, ids in step:
                by.setdefault(layer, []).append(ids)
        return {layer: torch.stack(v, 1) for layer, v in by.items()}

    calls = [_Call(warm["prompts"], warm["tokens"], warm["logits"], by_layer(steps[:n_warm]))]
    if not o.failed:        # the window's first call is the first answer
        prompts, tokens = o.answers[0]
        calls.append(_Call(prompts, tokens, None, by_layer(steps[n_warm:])))
    run.inputs["recorded"] = calls
    return calls


def _kth(biased, k: int):
    """(the ``k``-th largest biased score, the gap from it to the ``k+1``-th)."""
    top = biased.topk(k + 1, dim=-1).values
    return top[..., k - 1], top[..., k - 1] - top[..., k]


def _forced(run, call: _Call, quantize=None, scores: Optional[Dict] = None):
    """``call`` through the reference forced to the program's experts: (its
    logits, lazily: ``(first row, [b, steps, V])`` blocks on the device; the
    biased scores by layer, filled as the layers run; the largest depth, in
    a list filled as they run: of the program's choices below the ``k``-th
    biased score, or with ``quantize`` and ``scores`` (the float32 pass's)
    of the control's own choices below the float32 ``k``-th)."""
    import torch

    k = run.cfg["num_experts_per_tok"]
    seqs = torch.from_numpy(np.concatenate([call.prompts, call.tokens], 1))
    kept: Dict[int, Any] = {}
    depth = [0.0]

    def route(layer, r0, s, biased):
        prog = call.chosen[layer][r0:r0 + biased.shape[0]].to(biased.device)
        if scores is None:
            kept[layer] = torch.cat([kept[layer], biased]) if layer in kept else biased.clone()
            kth, _ = _kth(biased, k)
            low = biased.gather(-1, prog).amin(-1)
        else:
            fine = scores[layer][r0:r0 + biased.shape[0]]
            kth, _ = _kth(fine, k)
            low = fine.gather(-1, biased.topk(k, dim=-1).indices).amin(-1)
        depth[0] = max(depth[0], float((kth - low).max()))
        return prog

    blocks = ref_mod.logits_blocks(run.inputs["weights"], run.cfg, seqs.to(run.device),
                                   block=BLOCK, head_block=HEAD_BLOCK, quantize=quantize,
                                   route=route)
    return blocks, kept, depth


def _forced_readings(run, call: _Call, quantize=None) -> Dict[str, Any]:
    """``call`` against the routing-forced reference: the route depth, the
    gaps of the generated tokens (the program's, or the control's first
    token at each position) in the float32 forced reference with the wrong
    pads, and where the call kept the program's logits, their largest
    difference (the control's: its own forced logits') and the steps
    compared."""
    import torch

    dev, p = run.device, call.prompts.shape[1]
    toks = torch.from_numpy(call.tokens).to(dev)
    blocks, scores, depth = _forced(run, call)
    if quantize is None:
        mine = call.logits
        pairs = ((None if mine is None else mine[r0:r0 + lg.shape[0]], lg, None, r0)
                 for r0, lg in blocks)
    else:
        first = next(blocks)        # every layer has run: the float32 scores are whole
        low, _, depth = _forced(run, call, quantize=quantize, scores=scores)
        pairs = ((lg, f, lg, r0) for (_, lg), (r0, f) in zip(low, itertools.chain([first],
                                                                                  blocks)))
    worst, gap_max, off = None, 0.0, 0
    for other, f32, pick, r0 in pairs:
        if call.logits is not None:
            n = min(other.shape[1], f32.shape[1])
            d = torch.nan_to_num((other[:, :n].to(dev).float() - f32[:, :n]).abs(),
                                 nan=NOT_FINITE, posinf=NOT_FINITE).amax(dim=(0, 2))
            worst = d if worst is None else torch.maximum(worst, d)
        gap, wrong = _lm._token_gaps(f32, toks[r0:r0 + f32.shape[0]], p, run.cfg, pick)
        gap_max = max(gap_max, float(gap.max()))
        off += int((gap > run.cfg["limits"]["token_gap"]).sum()) + wrong
    return {"max_logit_dev": None if worst is None else float(worst.max()),
            "steps": 0 if worst is None else len(worst), "depth": depth[0], "gap_max": gap_max,
            "off": off, "tokens": toks.numel()}


def _readings(run, quantize=None, log=None) -> Dict[str, float]:
    """The judge's numbers of the program's answers, or, with ``quantize``,
    the control's, at the same prompts and served tokens."""
    import torch

    cfg, o, dev = run.cfg, run.outcome, run.device
    k, delta = cfg["num_experts_per_tok"], cfg["limits"]["route_delta"]
    t = time.perf_counter()
    forced = [_forced_readings(run, call, quantize) for call in _recorded(run)]
    t_forced = time.perf_counter() - t
    total, wrong_pads, compared, ties = 0.0, 0, 0, 0
    for prompts, tokens, _ in _lm._groups(o):
        seqs = torch.from_numpy(np.concatenate([prompts, tokens], 1)).to(dev)
        toks = torch.from_numpy(tokens).to(dev)
        margin = torch.full(seqs.shape, float("inf"), device=dev)

        def route(layer, r0, s, biased):
            rows = margin[r0:r0 + biased.shape[0]]
            torch.minimum(rows, _kth(biased, k)[1], out=rows)

        ref = ref_mod.logits_blocks(run.inputs["weights"], cfg, seqs, block=BLOCK,
                                    head_block=HEAD_BLOCK, route=route)
        low = (ref_mod.logits_blocks(run.inputs["weights"], cfg, seqs, block=BLOCK,
                                     head_block=HEAD_BLOCK, quantize=quantize)
               if quantize is not None else None)
        p, g = prompts.shape[1], tokens.shape[1]
        for r0, lg in ref:
            pick = next(low)[1] if low is not None else None
            gap, wrong = _lm._token_gaps(lg, toks[r0:r0 + HEAD_BLOCK], p, cfg, pick)
            total += float(gap.double().sum())
            wrong_pads += wrong
            compared += gap.numel()
            ties += int((margin[r0:r0 + HEAD_BLOCK, p - 1:p - 1 + g] <= delta).sum())
    near_tie = ties / max(compared, 1)
    if log is not None:
        log(f"routing-forced reference over {sum(f['tokens'] for f in forced)} generated tokens "
            f"of {len(forced)} calls: {t_forced:.3f} s; free reference over {compared}: "
            f"{time.perf_counter() - t - t_forced:.3f} s; positions with a routing near-tie "
            f"(within {delta}) at some layer: {near_tie:.4f}")
    return {"route_depth_max": max(f["depth"] for f in forced),
            "max_logit_dev": forced[0]["max_logit_dev"], "steps_compared": forced[0]["steps"],
            "tokens_off_margin": sum(f["off"] for f in forced) + wrong_pads,
            "token_gap_max": max(f["gap_max"] for f in forced),
            "forced_tokens_compared": sum(f["tokens"] for f in forced),
            "token_gap_mean": total / max(compared, 1), "tokens_compared": compared,
            "near_tie_share": near_tie}


def _checks(run, r: Dict[str, float]) -> Dict[str, Dict]:
    """The numbers ``r`` read, each with its limit or minimum."""
    lim = run.cfg["limits"]
    return {
        "route_depth_max": {"value": r["route_depth_max"], "limit": lim["route_delta"]},
        "max_logit_dev": {"value": r["max_logit_dev"], "limit": lim["max_logit_dev"]},
        "tokens_off_margin": {"value": r["tokens_off_margin"], "limit": 0},
        "token_gap_max": {"value": r["token_gap_max"], "limit": lim["token_gap"]},
        "token_gap_mean": {"value": r["token_gap_mean"], "limit": lim["token_gap_mean"]},
        "steps_compared": {"value": r["steps_compared"], "min": 1},
        "forced_tokens_compared": {"value": r["forced_tokens_compared"], "min": 1},
        "tokens_compared": {"value": r["tokens_compared"], "min": 1},
        "calls_failed": {"value": run.outcome.failed, "limit": 0},
    }


def _expert_counts() -> Optional[List[np.ndarray]]:
    """The program's group ends of every routed call under the profiler
    (the recorder's counts, disarmed)."""
    from repro_torch.models.moe import ROUTING

    counts = ROUTING.take_counts()
    return [c.cpu().numpy() for c in counts] or None


def judge(run, trace: bool, log) -> Tuple[Dict, Dict]:
    counts = _expert_counts()
    facts = {"expert_counts": counts} if trace else {}
    return _checks(run, _readings(run, log=log)), facts


def controls(cfg: Dict) -> List[str]:
    return ["fp8_e4m3"]


def control_checks(run, kind: str) -> Dict[str, Dict]:
    """The judge's checks with the control ``kind`` in the program's place:
    the reference with its weights rounded to float8 e4m3."""
    if kind != "fp8_e4m3":
        raise ValueError(f"no control {kind!r}")
    return _checks(run, _readings(run, quantize=ref_mod.fp8_e4m3))
