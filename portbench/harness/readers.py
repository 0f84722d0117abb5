"""The yardstick's arithmetic that the metric readers share: device idle,
and each kernel's operations and bytes, worked out from the shapes, the
configuration and the reference's word tests, never from the program.

  * ``fused_infer`` (clause evaluation and class sums): bytes are the
    packed literals in (``B * P * W`` int32 words), the include words
    (``C * W``), the nonempty flags (``C``), the int8 weights (``M * C``)
    and the int32 class sums out (``B * M``), each counted once;
    operations are the word tests its images need
    (:func:`harness.reference.classify`, one test per word of 32 literals
    of one (patch, clause) pair).
  * ``ingress_pack``: bytes are the booleanized images in (``B * Y * X``
    bytes) and the packed words out (``B * P * W`` int32); operations are
    one per word written.

A call's bound is the larger of its bytes over the memory rate and its
operations over the integer rate; a kernel's roofline share is the sum of
its calls' bounds over the sum of its device time in the traced window.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from harness import reference

FUSED_KERNEL = "fused_infer_kernel"
INGRESS_KERNEL = "ingress_pack_kernel"


def device_idle_pct(rec) -> Optional[float]:
    tr = rec.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def _dims(cfg):
    return (reference.n_patches(cfg), reference.n_words(cfg), cfg["n_clauses"],
            cfg["n_classes"], cfg["image_y"] * cfg["image_x"])


def fused_infer_bytes(cfg, b: int) -> int:
    p, w, c, m, _ = _dims(cfg)
    return 4 * b * p * w + 4 * c * w + c + m * c + 4 * b * m


def ingress_pack_bytes(cfg, b: int) -> int:
    p, w, _, _, yx = _dims(cfg)
    return b * yx + 4 * b * p * w


def ingress_pack_ops(cfg, b: int) -> int:
    p, w, *_ = _dims(cfg)
    return b * p * w


def _roofline(rec, kernel: str, nbytes, nops) -> Optional[float]:
    tr = rec.trace
    if tr is None or not rec.traced_calls or rec.card is None:
        return None
    launches, seconds = tr.kernel(kernel)
    if launches == 0 or seconds <= 0:
        return None
    card = rec.card
    bound = sum(max(nbytes(idx) / card["hbm_bytes_per_s"], nops(idx) / card["int_ops_per_s"])
                for idx in rec.traced_calls)
    return 100.0 * bound / seconds


def fused_infer_roofline_pct(rec) -> Optional[float]:
    tests = rec.facts.get("word_tests")
    if tests is None:
        return None
    return _roofline(rec, FUSED_KERNEL, lambda idx: fused_infer_bytes(rec.cfg, len(idx)),
                     lambda idx: int(tests[np.asarray(idx)].sum()))


def ingress_pack_roofline_pct(rec) -> Optional[float]:
    return _roofline(rec, INGRESS_KERNEL, lambda idx: ingress_pack_bytes(rec.cfg, len(idx)),
                     lambda idx: ingress_pack_ops(rec.cfg, len(idx)))


def classify_mfu_pct(rec) -> Optional[float]:
    tests = rec.facts.get("word_tests")
    if tests is None or rec.window_pool_idx is None or rec.card is None:
        return None
    window_tests = int(tests[rec.window_pool_idx].sum())
    return 100.0 * window_tests / (rec.window_s * rec.card["int_ops_per_s"])
