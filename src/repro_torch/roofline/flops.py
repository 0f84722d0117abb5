"""Analytic operations and device-memory bytes: the port's copy of the
reference's ``roofline/flops.py``, the same model, so the same numbers.

Two halves are here:

  * the LM substrate's forward model per (arch, shape) cell:
    ``flops_estimate`` (global FLOPs of a train, prefill or decode step,
    following ``models/`` term by term: executed attention is the full
    chunked score product, MoE is capacity-padded) and
    ``hbm_bytes_estimate`` (per-chip device-memory bytes of a step, a floor
    model: weights read once, KV cache and saved activations);
  * the ConvCoTM eval paths' ``tm_serve_costs`` and their path sets.

``collective_bytes_estimate`` gives the per-chip wire bytes of a step on
a mesh, by mechanism.  All LM numbers are global per step (divide by chips for per-chip terms);
matmul FLOPs are 2*m*n*k; a train step is 3x the forward.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = [
    "TM_FUSED_PATHS",
    "TM_SPARSE_PATHS",
    "collective_bytes_estimate",
    "flops_estimate",
    "hbm_bytes_estimate",
    "tm_serve_costs",
]


def _causal_window_pairs(s: int, window) -> float:
    """Sum over query i of visible keys (causal, optional window)."""
    if window is None or window >= s:
        return s * (s + 1) / 2.0
    w = window
    return w * (w + 1) / 2.0 + (s - w) * float(w)


def _attn_layer_flops(cfg: ModelConfig, b: int, s: int, window) -> float:
    """EXECUTED flops: the chunked-attention implementation computes the
    full [Sq, Sk] score matrix per chunk and masks (causal + window) — so
    executed attention flops are the full product, not the visible-pair
    count.  Skipping fully-masked key blocks is an optimisation not made
    here; ``_causal_window_pairs`` gives the ideal."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2.0 * b * s * d * (h * hd + 2 * kv * hd + h * hd)
    attn = 2.0 * b * h * hd * float(s) * float(s) * 2.0   # QK^T and AV
    return proj + attn


def _mlp_flops(cfg: ModelConfig, b: int, s: int) -> float:
    if cfg.d_ff == 0:
        return 0.0
    return 2.0 * b * s * cfg.d_model * cfg.d_ff * 3.0


def _moe_flops(cfg: ModelConfig, b: int, s: int) -> float:
    t = b * s
    d, ff = cfg.d_model, cfg.d_ff
    e, k = cfg.n_experts, cfg.n_experts_per_token
    router = 2.0 * t * d * e
    # Capacity-padded expert compute (the einsum really does E*C rows).
    cap_tokens = t * k * cfg.capacity_factor
    expert = 2.0 * cap_tokens * d * ff * 3.0
    dispatch = 2.0 * cap_tokens * d * 2.0          # dispatch + combine einsums
    shared = 0.0
    if cfg.n_shared_experts:
        ffs = cfg.d_ff_shared or ff * cfg.n_shared_experts
        shared = 2.0 * t * d * ffs * 3.0 + 2.0 * t * d
    return router + expert + dispatch + shared


def _mlstm_flops(cfg: ModelConfig, b: int, s: int, chunk: int = 64) -> float:
    up = int(cfg.d_model * cfg.proj_factor)
    h = cfg.n_heads
    hd = up // h
    d = cfg.d_model
    proj = 2.0 * b * s * (d * up * 2 + up * up * 3 + up * d + up * 2 * h)
    lc = min(chunk, s)
    nc = max(s // lc, 1)
    # per chunk per head: scores L^2 hd, intra AV L^2 hd, inter q@C L hd^2,
    # state update k@v^T L hd^2.
    cell = nc * b * h * (2.0 * lc * lc * hd * 2 + 2.0 * lc * hd * hd * 2)
    return proj + cell


def _slstm_flops(cfg: ModelConfig, b: int, s: int) -> float:
    d = cfg.d_model
    hd = d // cfg.n_heads
    proj = 2.0 * b * s * d * 4 * d
    rec = 2.0 * b * s * d * 4 * hd                 # block-diagonal recurrence
    ffn = _mlp_flops(cfg, b, s)
    return proj + rec + ffn


def _rglru_flops(cfg: ModelConfig, b: int, s: int) -> float:
    d = cfg.d_model
    w = cfg.rglru_lru_width or d
    proj = 2.0 * b * s * (d * w * 2 + w * d)
    gates = 2.0 * b * s * w * w * 2
    conv = 2.0 * b * s * w * cfg.conv_width
    return proj + gates + conv + _mlp_flops(cfg, b, s)


def _layer_flops(cfg: ModelConfig, kind: str, b: int, s: int) -> float:
    window = cfg.sliding_window or cfg.local_window
    if kind == "attn":
        mlp = _moe_flops(cfg, b, s) if cfg.is_moe else _mlp_flops(cfg, b, s)
        return _attn_layer_flops(cfg, b, s, window) + mlp
    if kind == "rglru":
        return _rglru_flops(cfg, b, s)
    if kind == "mlstm":
        return _mlstm_flops(cfg, b, s)
    if kind == "slstm":
        return _slstm_flops(cfg, b, s)
    raise ValueError(kind)


def _forward_flops(cfg: ModelConfig, b: int, s: int) -> float:
    total = 0.0
    for i in range(cfg.n_layers):
        total += _layer_flops(cfg, cfg.pattern_for_layer(i), b, s)
    if cfg.is_encoder_decoder:
        # Encoder (bidirectional full attention) + decoder cross-attention.
        for _ in range(cfg.n_encoder_layers):
            total += (
                2.0 * b * s * cfg.d_model
                * (2 * cfg.n_heads * cfg.head_dim + 2 * cfg.n_kv_heads * cfg.head_dim)
                + 2.0 * b * cfg.n_heads * cfg.head_dim * s * s * 2.0
                + _mlp_flops(cfg, b, s)
            )
        # cross-attn per decoder layer: q from dec len sd, kv over enc len s
        sd = max(s // 4, 16)
        total += cfg.n_layers * (
            2.0 * b * sd * cfg.d_model * 2 * cfg.n_heads * cfg.head_dim
            + 2.0 * b * cfg.n_heads * cfg.head_dim * sd * s * 2.0
        )
    return total


def _head_flops(cfg: ModelConfig, b: int, s: int) -> float:
    return 2.0 * b * s * cfg.d_model * cfg.vocab_size


def _decode_layer_flops(cfg: ModelConfig, kind: str, b: int, kv_len: int) -> float:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window or cfg.local_window
    if kind == "attn":
        eff = min(kv_len, window) if window else kv_len
        proj = 2.0 * b * d * (h * hd + 2 * kv * hd + h * hd)
        att = 2.0 * b * h * hd * eff * 2.0
        mlp = (_moe_flops(cfg, b, 1) if cfg.is_moe else _mlp_flops(cfg, b, 1))
        return proj + att + mlp
    if kind == "rglru":
        return _rglru_flops(cfg, b, 1)
    if kind == "mlstm":
        up = int(d * cfg.proj_factor)
        hd2 = up // cfg.n_heads
        proj = 2.0 * b * (d * up * 2 + up * up * 3 + up * d)
        cell = 2.0 * b * cfg.n_heads * hd2 * hd2 * 2
        return proj + cell
    if kind == "slstm":
        return _slstm_flops(cfg, b, 1)
    raise ValueError(kind)


def flops_estimate(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global FLOPs per step for the cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.is_encoder_decoder:
            sd = max(s // 4, 16)
            fwd = _forward_flops(cfg, b, s) + _head_flops(cfg, b, sd)
        else:
            fwd = _forward_flops(cfg, b, s) + _head_flops(cfg, b, s)
        return 3.0 * fwd
    if shape.kind == "prefill":
        if cfg.is_encoder_decoder:
            return _forward_flops(cfg, b, s) + _head_flops(cfg, b, 1)
        return _forward_flops(cfg, b, s) + _head_flops(cfg, b, 1)
    # decode: one token against a kv_len cache
    total = 0.0
    for i in range(cfg.n_layers):
        total += _decode_layer_flops(cfg, cfg.pattern_for_layer(i), b, s)
    if cfg.is_encoder_decoder:
        # cross-attn against enc len s
        total += cfg.n_layers * (
            2.0 * b * cfg.d_model * 2 * cfg.n_heads * cfg.head_dim
            + 2.0 * b * cfg.n_heads * cfg.head_dim * s * 2.0
        )
    return total + _head_flops(cfg, b, 1)


# ---------------------------------------------------------------------------
# HBM traffic (per chip)
# ---------------------------------------------------------------------------

def hbm_bytes_estimate(
    cfg: ModelConfig, shape: ShapeConfig, chips: int, microbatches: int = 1
) -> float:
    """Per-chip HBM bytes per step (weight streams + major activations).

    Weights: each microbatch's fwd+bwd reads the (sharded) weights from
    HBM; optimizer reads+writes master/m/v once.  Activations: remat saves
    layer inputs; attention KV and logits streams included.  This is a
    floor model (perfect fusion assumed) — good to ~2x, which is enough to
    identify the dominant roofline term.
    """
    pb = 2.0 * cfg.param_count() / chips               # bf16 shard
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    if shape.kind == "train":
        w = pb * (2 * microbatches + 1)                # fwd+bwd per microbatch
        opt = (cfg.param_count() / chips) * 4.0 * 3 * 2  # m,v,master rw fp32
        act = 2.0 * b * s * d * 2 * cfg.n_layers / chips * 2
        return w + opt + act
    if shape.kind == "prefill":
        act = 2.0 * b * s * d * 2 * cfg.n_layers / chips
        return pb + act
    # decode: weights + KV cache read + state
    window = cfg.sliding_window or cfg.local_window
    kv_len = min(s, window) if window else s
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.pattern_for_layer(i) == "attn")
    kv_bytes = (
        2.0 * b * cfg.n_kv_heads * kv_len * cfg.head_dim * 2 * n_attn / chips
    )
    return pb * (cfg.active_param_count() / max(cfg.param_count(), 1)) + kv_bytes


# ---------------------------------------------------------------------------
# Collective traffic (per chip, wire bytes)
# ---------------------------------------------------------------------------

def _ar_per_layer(cfg: ModelConfig, parallel_block: bool) -> float:
    """Tensor-parallel all-reduces per layer (forward), by block kind."""
    per_kind = {"attn": 1.0 if parallel_block else 2.0,
                "rglru": 2.0, "mlstm": 1.0, "slstm": 2.0}
    total = 0.0
    for i in range(cfg.n_layers):
        total += per_kind[cfg.pattern_for_layer(i)]
    if cfg.is_encoder_decoder:
        total += 2.0 * cfg.n_encoder_layers + cfg.n_layers  # enc + cross-attn
    return total


def collective_bytes_estimate(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    dp: int,
    tp: int,
    pods: int = 1,
    microbatches: int = 1,
    profile: str = "tp",
    parallel_block: bool = False,
    gather_hoisted: bool = False,
    pod_int8: bool = False,
) -> Dict[str, float]:
    """Per-chip wire bytes per step, by mechanism.

    * tp - activation all-reduces (ring wire 2x of b_dev*s*d bf16), counted
      per layer from the block mix; x3 for train (fwd + 2 bwd dgrads).
      ``parallel_block`` merges attn+mlp into one all-reduce.
    * fsdp - ZeRO param all-gathers (bf16) per microbatch fwd + bwd, and
      fp32 grad reduce-scatter per microbatch.  ``gather_hoisted`` models
      one forward gather per step and a backward regather per microbatch.
      Profiles: 'tp' gathers params/tp per chip over the data axis; 'dp'
      gathers full params per chip (no TP); 'serve_tp' gathers nothing
      (decode-resident weights).
    * pod - inter-pod fp32 gradient all-reduce of each chip's shard; /4
      with int8 + error-feedback compression.
    * ep - MoE expert-parallel all-to-all (dispatch + combine).
    """
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    params = cfg.param_count()
    out: Dict[str, float] = {"fsdp": 0.0, "tp": 0.0, "pod": 0.0, "ep": 0.0}
    k = microbatches
    tp_eff = 1 if profile == "dp" else tp
    b_dev = max(b // (dp * pods), 1)
    tokens_dev = b_dev * (s if shape.kind != "decode" else 1)

    # --- fsdp param gathers + grad reduce-scatter ---
    if profile == "serve_tp":
        gathered = 0.0
    elif profile == "dp":
        gathered = 2.0 * params                       # full params, bf16
    else:
        gathered = 2.0 * params / tp                  # data-axis shard only
    if shape.kind == "train":
        n_gather = (1 + k) if gather_hoisted else (2 * k)
        rs = (2.0 * gathered) * k                     # fp32 grads, ring ~1x
        out["fsdp"] = gathered * n_gather + rs
    elif gathered:
        out["fsdp"] = gathered                        # one gather per call

    # --- tensor-parallel activation all-reduces ---
    if tp_eff > 1:
        n_ar_fwd = _ar_per_layer(cfg, parallel_block)
        mult = 3.0 if shape.kind == "train" else 1.0
        per_ar = tokens_dev * d * 2.0 * 2.0           # bf16, ring wire 2x
        out["tp"] = per_ar * n_ar_fwd * mult

    # --- inter-pod gradient sync ---
    if pods > 1 and shape.kind == "train":
        pod_bytes = 2.0 * 4.0 * params / (dp * tp_eff)
        out["pod"] = pod_bytes / (4.0 if pod_int8 else 1.0)

    # --- expert-parallel all-to-all ---
    if cfg.is_moe and cfg.n_experts % tp == 0 and tp > 1 and profile != "dp":
        cap = tokens_dev * cfg.n_experts_per_token * cfg.capacity_factor
        mult = 3.0 if shape.kind == "train" else 1.0
        out["ep"] = 2.0 * cap * d * 2.0 * mult

    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# ConvCoTM serving paths (ops / HBM bytes per batch)
# ---------------------------------------------------------------------------

#: Paths whose clause axis is the active pool (empty clauses pruned by
#: ``serve.servable.analyze_sparsity``) rather than the full pool.
TM_SPARSE_PATHS = ("sparse", "fused_sparse", "matmul_sparse")

#: Paths whose clause outputs never round-trip through device memory
#: (class sums taken inside the kernel).
TM_FUSED_PATHS = ("fused", "fused_sparse")


def tm_serve_costs(
    config, path_name: str, batch: int = 1, *, n_active: Optional[int] = None
) -> Dict[str, float]:
    """Analytic op and byte costs of one ConvCoTM eval-path batch.

    ``config`` is a :class:`~repro_torch.core.cotm.CoTMConfig` (geometry
    fields only); ``n_active`` is the active-clause count of the sparse
    paths (default: the full pool).  Returns:

      * ``ops``: elementary operations, one per lane-element operation:
        multiply-adds counted twice for the matmul paths, word operations
        (not, and, compare) for the packed paths, byte ANDs and compares
        for ``dense``;
      * ``bytes``: the device-memory floor: the literal stream in, the
        model image read once per batch, the clause outputs' round trip
        for the unfused paths, the class sums out;
      * ``lit_bytes``, ``model_bytes`` and ``clauses_evaluated``.
    """
    spec = config.patch
    b = float(batch)
    p = float(spec.n_patches)        # patches per image
    lit = float(spec.n_literals)     # 2o dense literal bits
    w = float(spec.n_words)          # packed 32-bit words per patch
    c = float(config.n_clauses)
    m = float(config.n_classes)
    c_a = c if n_active is None else float(n_active)
    c_eval = c_a if path_name in TM_SPARSE_PATHS else c

    sums_ops = 2.0 * b * c_eval * m          # Eq. (3) int8 dot
    or_ops = b * c_eval * p                  # sequential OR (Eq. 6)

    if path_name == "dense":
        ops = 2.0 * b * p * c * lit + or_ops + sums_ops     # AND + reduce
        lit_bytes = b * p * lit                              # uint8 stream
        model_bytes = c * lit + c + m * c
    elif path_name in ("matmul", "matmul_sparse"):
        # Violation-count matmul: 2*B*P*C*2o + the zero compare.
        ops = 2.0 * b * p * c_eval * lit + b * p * c_eval + or_ops + sums_ops
        lit_bytes = b * p * lit
        model_bytes = c_eval * lit + m * c_eval
    elif path_name in ("bitpacked", "kernel", "fused", "sparse", "fused_sparse"):
        # Word operations per (patch, clause, word): not, and, compare.
        ops = 3.0 * b * p * c_eval * w + or_ops + sums_ops
        lit_bytes = b * p * w * 4.0                          # 32-bit word stream
        model_bytes = c_eval * w * 4.0 + m * c_eval
        if path_name in ("bitpacked", "kernel"):
            model_bytes += c                                 # nonempty mask
    else:
        raise ValueError(f"no cost model for eval path {path_name!r}")

    out_bytes = b * m * 4.0                                  # int32 class sums
    fired_bytes = 0.0 if path_name in TM_FUSED_PATHS else 2.0 * b * c_eval
    return {
        "ops": ops,
        "bytes": lit_bytes + model_bytes + fired_bytes + out_bytes,
        "lit_bytes": lit_bytes,
        "model_bytes": model_bytes,
        "clauses_evaluated": c_eval,
    }
