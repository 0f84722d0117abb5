"""The seeded model: TA states and int8 weights in the shape of a trained
ConvCoTM, made from ``--seed`` (there is no trained model in the repo).

A share of the clauses is empty (``assumed.empty_clause_share`` of the
configuration).  Every other clause includes ``k`` literals, ``k`` drawn
from the configuration's ``assumed.literals_per_clause`` (the include
counts of a trained model's clauses), and the ``k`` are drawn from the
literals that are true in one patch of one glyph of the pool, so the
clause fires on that patch and on patterns like it, as trained clauses
do.  Weights are uniform in [-127, 127].  The state is 35 KB, made on the
host from one NumPy generator in a few vectorised calls, so that one
seed gives one model on every machine.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from harness import reference

__all__ = ["make_model"]


def make_model(rng: np.random.Generator, cfg: Dict,
               pool: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(TA states uint8 ``[C, 2o]``, weights int32 ``[M, C]``) from ``rng``,
    with the clauses' literals drawn from patches of ``pool``'s images."""
    c, m = cfg["n_clauses"], cfg["n_classes"]
    assumed = cfg["assumed"]
    p = reference.n_patches(cfg)
    img = rng.integers(0, len(pool), c)
    patch = rng.integers(0, p, c)
    lits = reference.literals(reference.booleanize(pool[img], cfg["booleanize"]), cfg)
    lits = lits[np.arange(c), patch]                         # [C, 2o], half of them 1
    counts = rng.choice(np.asarray(assumed["literals_per_clause"]), c)
    counts = np.minimum(counts, lits.sum(axis=1))
    keys = np.where(lits == 1, rng.random(lits.shape), 2.0)  # only true literals rank first
    rank = np.argsort(np.argsort(keys, axis=1), axis=1)
    include = rank < counts[:, None]
    include[rng.random(c) < assumed["empty_clause_share"]] = False
    half = reference.TA_INCLUDE
    ta = np.where(include, half + rng.integers(0, 256 - half, include.shape),
                  rng.integers(0, half, include.shape)).astype(np.uint8)
    weights = rng.integers(-127, 128, (m, c)).astype(np.int32)
    return ta, weights
