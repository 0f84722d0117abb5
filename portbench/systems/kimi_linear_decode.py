"""The Kimi Linear decode system: ``repro_torch``'s hybrid of Kimi Delta
Attention and latent attention with sigmoid-routed experts
(Kimi-Linear-48B-A3B at a chip's share of its experts), served through
``repro_torch.launch.serve.generate``, judged against the plain float32
reference (``harness/kimi_linear_reference.py``).

The configuration is the model's own ``config.json`` keys, with
``num_experts`` the experts held here and ``experts_routed`` the router's
width; they configure the program's registered architecture ``arch``
(:func:`model_config`).  The weights are the harness's
(``kimi_linear_reference.make_weights``, seeded from the model stream) and
the program's parameter tree holds them as they are.  ``make`` arms the
program's routing recorder for ``route_steps`` decode steps (the warm-up
call's and the window's first call's) and for the group counts of the
traced call.  The load generator is ``lm_generate``.

The judge is ``mla_moe_decode``'s, routing-forced, for the same reason:
on random weights the top 8 of 256 sigmoid scores nearly tie at some
expert layer at nearly every position, and a float32 reference then
routes other than the bf16 program does.  Its checks:

  * ``route_depth_max``: on both recorded calls, how far below that
    layer's 8th biased score the lowest expert the program chose lies;
    limit ``limits.route_delta``;
  * ``max_logit_dev``: the warm-up call's logits at every decode step
    against the routing-forced reference; limit ``limits.max_logit_dev``;
  * ``tokens_off_margin`` and ``token_gap_max``: every generated token of
    both recorded calls against the forced reference (limit
    ``limits.token_gap``; the count past it, limit 0), plus any token
    after a latched end-of-sequence that is not the pad id;
  * ``token_gap_mean``: every generated token of every call against the
    plain reference routing by itself, the mean gap, limit
    ``limits.token_gap_mean``;
  * ``steps_compared``, ``forced_tokens_compared`` and ``tokens_compared``
    at least 1, ``calls_failed`` limit 0.

The control (``control.py``) is the reference with every matrix, the
router and the embedding rounded to float8 e4m3 (one scale per tensor).
The functions of ``mla_moe_decode`` that take no reference are used as
they are; those that run one are copied here with this reference.
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from harness import kimi_linear_reference as ref_mod
from harness.cell import STREAM_MODEL, _module

__all__ = ["control_checks", "controls", "judge", "make", "model_config"]

_lm = _module(Path(__file__).with_name("lm_decode.py"))
_mm = _module(Path(__file__).with_name("mla_moe_decode.py"))
Served, NOT_FINITE = _lm.Served, _lm.NOT_FINITE
#: Sequences the reference's layers run at a time (a KDA state of 64
#: sequences is 537 MB in float32), and its head: the float32 logits of 8
#: sequences at 256 positions over 163,840 ids take 1.3 GB.
BLOCK, HEAD_BLOCK = 64, 8


def model_config(cfg: Dict):
    """The program's ``ModelConfig`` of the configuration (its registered
    ``arch`` with the configuration's values, ``num_experts`` of
    ``experts_routed`` held): raises at once where the program has no
    such arch or the configuration asks for what it lacks."""
    import torch

    from repro_torch.configs import get_config

    fixed = {"q_lora_rank": None, "num_expert_group": 1, "topk_group": 1,
             "moe_router_activation_func": "sigmoid", "moe_renormalize": True,
             "hidden_act": "silu", "num_nextn_predict_layers": 0, "moe_layer_freq": 1,
             "mla_use_nope": True, "rope_scaling": None, "use_grouped_topk": True}
    odd = {k: cfg.get(k) for k, v in fixed.items() if cfg.get(k) != v}
    lac = cfg["linear_attn_config"]
    layers = cfg["num_hidden_layers"]
    if sorted(lac["kda_layers"] + lac["full_attn_layers"]) != list(range(1, layers + 1)):
        odd["linear_attn_config"] = "layers that are neither KDA nor full attention"
    if lac["num_heads"] != cfg["num_attention_heads"]:
        odd["linear_attn_config.num_heads"] = lac["num_heads"]
    if odd:
        raise ValueError(f"the program does not take {odd}")
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    full = set(lac["full_attn_layers"])
    return dataclasses.replace(
        get_config(cfg["arch"]),
        n_layers=layers, d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["moe_intermediate_size"], vocab_size=cfg["vocab_size"], head_dim=nope + rope,
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=nope, qk_rope_head_dim=rope,
        v_head_dim=cfg["v_head_dim"], mla_rope=not cfg["mla_use_nope"],
        kda_head_dim=lac["head_dim"], conv_width=lac["short_conv_kernel_size"],
        layer_kinds=tuple("mla" if i + 1 in full else "kda" for i in range(layers)),
        n_experts=cfg["experts_routed"], n_experts_held=cfg["num_experts"],
        first_expert_held=cfg["first_expert_held"],
        n_experts_per_token=cfg["num_experts_per_token"],
        n_shared_experts=cfg["num_shared_experts"],
        d_ff_shared=cfg["moe_intermediate_size"] * cfg["num_shared_experts"],
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


def _forced(run, call, quantize=None, scores: Optional[Dict] = None):
    """``call`` through the reference forced to the program's experts
    (``mla_moe_decode._forced`` with this reference)."""
    import torch

    k = run.cfg["num_experts_per_token"]
    seqs = torch.from_numpy(np.concatenate([call.prompts, call.tokens], 1))
    kept: Dict[int, Any] = {}
    depth = [0.0]

    def route(layer, r0, s, biased):
        prog = call.chosen[layer][r0:r0 + biased.shape[0]].to(biased.device)
        if scores is None:
            kept[layer] = torch.cat([kept[layer], biased]) if layer in kept else biased.clone()
            kth, _ = _mm._kth(biased, k)
            low = biased.gather(-1, prog).amin(-1)
        else:
            fine = scores[layer][r0:r0 + biased.shape[0]]
            kth, _ = _mm._kth(fine, k)
            low = fine.gather(-1, biased.topk(k, dim=-1).indices).amin(-1)
        depth[0] = max(depth[0], float((kth - low).max()))
        return prog

    blocks = ref_mod.logits_blocks(run.inputs["weights"], run.cfg, seqs.to(run.device),
                                   block=BLOCK, head_block=HEAD_BLOCK, quantize=quantize,
                                   route=route)
    return blocks, kept, depth


def _forced_readings(run, call, quantize=None) -> Dict[str, Any]:
    """``call`` against the routing-forced reference
    (``mla_moe_decode._forced_readings`` with this reference)."""
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
    the control's (``mla_moe_decode._readings`` with this reference)."""
    import torch

    cfg, o, dev = run.cfg, run.outcome, run.device
    k, delta = cfg["num_experts_per_token"], cfg["limits"]["route_delta"]
    t = time.perf_counter()
    forced = [_forced_readings(run, call, quantize) for call in _mm._recorded(run)]
    t_forced = time.perf_counter() - t
    total, wrong_pads, compared, ties = 0.0, 0, 0, 0
    for prompts, tokens, _ in _lm._groups(o):
        seqs = torch.from_numpy(np.concatenate([prompts, tokens], 1)).to(dev)
        toks = torch.from_numpy(tokens).to(dev)
        margin = torch.full(seqs.shape, float("inf"), device=dev)

        def route(layer, r0, s, biased):
            rows = margin[r0:r0 + biased.shape[0]]
            torch.minimum(rows, _mm._kth(biased, k)[1], out=rows)

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


def judge(run, trace: bool, log) -> Tuple[Dict, Dict]:
    counts = _mm._expert_counts()
    facts = {"expert_counts": counts} if trace else {}
    return _mm._checks(run, _readings(run, log=log)), facts


def controls(cfg: Dict) -> List[str]:
    return ["fp8_e4m3"]


def control_checks(run, kind: str) -> Dict[str, Dict]:
    """The judge's checks with the control ``kind`` in the program's place:
    the reference with its weights rounded to float8 e4m3."""
    if kind != "fp8_e4m3":
        raise ValueError(f"no control {kind!r}")
    return _mm._checks(run, _readings(run, quantize=ref_mod.fp8_e4m3))
