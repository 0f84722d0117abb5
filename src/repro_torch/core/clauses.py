"""Clause evaluation (counterpart of ``repro/core/clauses.py``).

A clause fires on a patch iff every included literal is 1; it fires for
the image iff it fires on at least one patch (the ASIC's sequential OR)
and it is nonempty (the ``Empty`` signal, paper Sec. IV-D).

Three equal evaluation paths: dense 0/1 literals, packed int32 words, and
a float32 matmul of violation counts; plus the packed test over the
active clause pool's exclude words.  The per-patch outputs
(:func:`patch_clause_outputs`, :func:`patch_clause_outputs_matmul`) feed
training, where an empty clause outputs 1 (so it can learn its first
includes) instead of the ``Empty`` signal's 0.  Each walks the patch axis in
chunks so its ``[B, Pc, C, .]`` temporary stays small; the OR over chunks
is the same OR.
"""

from __future__ import annotations

import torch

__all__ = [
    "clause_nonempty",
    "patch_clause_outputs",
    "patch_clause_outputs_matmul",
    "eval_clauses_dense",
    "eval_clauses_bitpacked",
    "eval_clauses_sparse",
    "eval_clauses_matmul",
    "class_sums",
    "argmax_predict",
    "patch_chunk",
]

#: Element budget of one patch chunk's ``[B, Pc, C, K]`` temporary.
_CHUNK_ELEMS = 1 << 24


def patch_chunk(b: int, c: int, k: int, p: int) -> int:
    """Patches per chunk so that ``b * chunk * c * k`` stays within budget."""
    return max(1, min(p, _CHUNK_ELEMS // max(1, b * c * k)))


def clause_nonempty(include: torch.Tensor) -> torch.Tensor:
    """[C, 2o] 0/1 include mask -> [C] bool nonempty flags."""
    return (include > 0).any(dim=-1)


def patch_clause_outputs(
    literals: torch.Tensor, include: torch.Tensor, training: bool = False
) -> torch.Tensor:
    """Per-patch clause outputs before the sequential OR, from uint8 0/1
    literals ``[B, P, 2o]`` and include ``[C, 2o]``: uint8 0/1 ``[B, P, C]``.
    With ``training`` an empty clause outputs 1, else 0."""
    b, p, n = literals.shape
    c = include.shape[0]
    inc = include[None, None] > 0                        # [1, 1, C, 2o]
    out = torch.empty((b, p, c), dtype=torch.uint8, device=literals.device)
    step = patch_chunk(b, c, n, p)
    for p0 in range(0, p, step):
        lit = literals[:, p0 : p0 + step, None, :]       # [B, Pc, 1, 2o]
        out[:, p0 : p0 + step] = (~(inc & (lit == 0)).any(dim=-1)).to(torch.uint8)
    if not training:
        out &= clause_nonempty(include).to(torch.uint8)[None, None]
    return out


def patch_clause_outputs_matmul(
    literals: torch.Tensor, include: torch.Tensor, training: bool = False
) -> torch.Tensor:
    """:func:`patch_clause_outputs` as a float32 matmul of violation counts
    ``(1 - literals) @ includeᵀ``: a clause fires on a patch iff its count
    is 0.  Operands are 0/1 and counts at most 2o <= 8192 < 2^24, so the
    counts are exact on both devices (in TF32 too); only ``== 0`` is read."""
    neg = (1 - literals).to(torch.float32)               # [B, P, 2o]
    fires = torch.matmul(neg, include.to(torch.float32).t()) == 0   # [B, P, C]
    if not training:
        fires &= clause_nonempty(include)[None, None]
    return fires.to(torch.uint8)


def eval_clauses_dense(literals: torch.Tensor, include: torch.Tensor) -> torch.Tensor:
    """Sequential-OR clause outputs from uint8 0/1 literals.  [B, P, 2o] -> uint8 [B, C]."""
    b, p, n = literals.shape
    c = include.shape[0]
    inc = include[None, None] > 0                        # [1, 1, C, 2o]
    fired = torch.zeros((b, c), dtype=torch.bool, device=literals.device)
    step = patch_chunk(b, c, n, p)
    for p0 in range(0, p, step):
        lit = literals[:, p0 : p0 + step, None, :]       # [B, Pc, 1, 2o]
        viol = (inc & (lit == 0)).any(dim=-1)            # [B, Pc, C]
        fired |= (~viol).any(dim=1)
    return (fired & clause_nonempty(include)[None]).to(torch.uint8)


def eval_clauses_bitpacked(
    lit_packed: torch.Tensor, include_packed: torch.Tensor, nonempty: torch.Tensor
) -> torch.Tensor:
    """Sequential-OR clause outputs from int32 words.

    ``lit_packed`` [B, P, W], ``include_packed`` [C, W], ``nonempty`` [C]
    -> uint8 0/1 [B, C].  A clause fires on a patch iff
    ``include & ~lit == 0`` on every word.
    """
    b, p, w = lit_packed.shape
    c = include_packed.shape[0]
    fired = torch.zeros((b, c), dtype=torch.bool, device=lit_packed.device)
    step = patch_chunk(b, c, w, p)
    for p0 in range(0, p, step):
        lit = lit_packed[:, p0 : p0 + step, None, :]     # [B, Pc, 1, W]
        viol = include_packed[None, None] & ~lit         # [B, Pc, C, W]
        fired |= (viol == 0).all(dim=-1).any(dim=1)
    return (fired & nonempty.to(torch.bool)[None]).to(torch.uint8)


def eval_clauses_sparse(lit_packed: torch.Tensor, exclude_packed: torch.Tensor) -> torch.Tensor:
    """Sequential-OR outputs of the active clauses from int32 words.

    ``lit_packed`` [B, P, W], ``exclude_packed`` [C_a, W] (``~include``,
    pad bits set) -> uint8 0/1 [B, C_a].  A clause fires on a patch iff
    ``~(lit | exclude) == 0`` on every word; the active pool has no
    nonempty mask.
    """
    b, p, w = lit_packed.shape
    c = exclude_packed.shape[0]
    fired = torch.zeros((b, c), dtype=torch.bool, device=lit_packed.device)
    step = patch_chunk(b, c, w, p)
    for p0 in range(0, p, step):
        lit = lit_packed[:, p0 : p0 + step, None, :]     # [B, Pc, 1, W]
        miss = ~(lit | exclude_packed[None, None])       # [B, Pc, C_a, W]
        fired |= (miss == 0).all(dim=-1).any(dim=1)
    return fired.to(torch.uint8)


def eval_clauses_matmul(
    literals: torch.Tensor,
    include: torch.Tensor,
    nonempty: torch.Tensor | None = None,
) -> torch.Tensor:
    """Violation counts ``(1 - literals) @ includeᵀ`` as a float32 matmul;
    a clause fires on a patch iff its count is 0.  Counts are at most
    2o <= 8192, exact in float32 (and in TF32, whose inputs here are 0/1)."""
    b, p, _ = literals.shape
    c = include.shape[0]
    inc_t = include.to(torch.float32).t()                # [2o, C]
    fired = torch.zeros((b, c), dtype=torch.bool, device=literals.device)
    step = patch_chunk(b, c, 1, p)
    for p0 in range(0, p, step):
        neg = (1 - literals[:, p0 : p0 + step]).to(torch.float32)
        fired |= (torch.matmul(neg, inc_t) == 0).any(dim=1)
    if nonempty is None:
        nonempty = clause_nonempty(include)
    return (fired & nonempty.to(torch.bool)[None]).to(torch.uint8)


def class_sums(fired: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Eq. (3): v_i = sum_j w_ij * c_j with int8 weights, int32 ``[B, m]``.

    A broadcast multiply and sum in int32: integer ``matmul`` has no CUDA
    implementation for int32, and this runs on both devices.
    """
    f = fired.to(torch.int32)[:, None, :]                # [B, 1, C]
    w = weights.to(torch.int8).to(torch.int32)[None]     # [1, m, C]
    return (f * w).sum(dim=-1, dtype=torch.int32)


def argmax_predict(v: torch.Tensor) -> torch.Tensor:
    """Eq. (4) with the ASIC's tie rule: ties go to the lowest class index,
    which is ``torch.argmax``'s documented first-occurrence rule."""
    return torch.argmax(v, dim=-1).to(torch.int32)
