"""The ConvCoTM system: ``repro_torch``'s serving engine classifying the
seeded glyph pool, judged answer by answer against the plain classify
step.

The pool comes from the seed's pool stream (``harness/glyphs.py``), the
TA states and weights from its model stream (``harness/model_state.py``),
the engine from ``harness/program.py``; the load generators draw their
requests from the pool with the traffic stream.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np

from harness import program, reference
from harness.cell import STREAM_MODEL, STREAM_POOL, Outcome
from harness.glyphs import glyph_pool
from harness.model_state import make_model

__all__ = ["control_checks", "controls", "judge", "judge_answers", "make"]


def make(cfg: Dict, streams, name: str, device):
    """(engine, pool, inputs): the glyph pool, the seeded model, and a
    ``ServingEngine`` on ``device`` serving it under ``name``."""
    pool = glyph_pool(streams[STREAM_POOL], cfg["pool_images"])
    ta, weights = make_model(streams[STREAM_MODEL], cfg, pool)
    engine = program.build_engine(cfg, name, ta, weights, device)
    return engine, pool, {"pool": pool, "ta": ta, "weights": weights}


def judge_answers(outcome: Outcome, ref_sums: np.ndarray, ref_preds: np.ndarray) -> Dict:
    """The numbers compared and their limits: answers whose class sums or
    prediction differ from the reference's (or from an earlier answer to
    the same image), plus answers that never came (limit 0), and the
    answers compared (at least 1)."""
    bad, compared = outcome.missing + outcome.inconsistent, outcome.inconsistent
    for idx, sums, preds, times in outcome.answers:
        idx = np.asarray(idx)
        rows = (np.asarray(sums, np.int64) != ref_sums[idx]).any(axis=1)
        rows |= np.asarray(preds, np.int64) != ref_preds[idx]
        bad += int(rows.sum()) * times
        compared += len(idx) * times
    return {"bad_answers": {"value": bad, "limit": 0},
            "answers_compared": {"value": compared, "min": 1}}


def judge(run, trace: bool, log) -> Tuple[Dict, Dict]:
    """Every answer against the reference over the whole pool; in traced
    runs the word tests per pool image go on the record for the kernel
    readers."""
    x = run.inputs
    t = time.perf_counter()
    sums, preds, tests = reference.classify(x["pool"], run.cfg, x["ta"], x["weights"],
                                            device=run.device, want_word_tests=trace)
    checks = judge_answers(run.outcome, sums, preds)
    log(f"reference over the {len(x['pool'])} pool images: {time.perf_counter() - t:.3f} s")
    return checks, {"word_tests": tests}


def controls(cfg: Dict) -> list:
    return ["int4"] + (["bf16"] if cfg["booleanize"]["method"] == "adaptive" else [])


def control_checks(run, kind: str) -> Dict:
    """The judge's checks with the control ``kind`` in the program's place:
    its answers to the same pool images the program answered, as many
    times, against the reference's."""
    x, o = run.inputs, run.outcome
    sums, preds, _ = reference.classify(x["pool"], run.cfg, x["ta"], x["weights"],
                                        device=run.device)
    c_sums, c_preds, _ = reference.classify(x["pool"], run.cfg, x["ta"], x["weights"],
                                            device=run.device, control=kind)
    bad, compared = 0, 0
    for idx, _, _, times in o.answers:
        idx = np.asarray(idx)
        rows = (c_sums[idx] != sums[idx]).any(axis=1) | (c_preds[idx] != preds[idx])
        bad += int(rows.sum()) * times
        compared += len(idx) * times
    return {"bad_answers": {"value": bad, "limit": 0},
            "answers_compared": {"value": compared, "min": 1}}
