"""A closed loop of whole ``repro_torch.launch.serve.generate`` calls, back
to back, from one client.

Traffic parameters (``portbench/traffic/<name>.json``):

  * ``batch``: sequences in each call;
  * ``prompt``, ``gen``: prompt ids a sequence (teacher-forced through the
    decode path, as ``generate`` does) and greedy tokens it generates;
  * ``max_seq``: the decode cache's positions (``generate``'s
    ``max_seq``);
  * ``warm_prompt``, ``warm_gen``: the warm-up call, of the same batch and
    ``max_seq``; the logits of each of its decode steps, as
    ``train/serve_step.decode`` returns them to ``generate``, are kept on
    the host for the judge (so they add nothing to the card's peak);
  * ``trace_prompt``, ``trace_gen``: the call traced with ``trace``.

Every decode step of a call has the same shapes whatever its position
(the cache holds ``max_seq`` positions, masked), so the short warm-up
call warms every shape of the window's calls.  Prompt ids are uniform
over the vocabulary, drawn from the traffic stream call by call, so every
seed sends the same sizes.  The window's calls are those started inside
it; the window's seconds run from the first one's start to the last
one's end (the tokens are back on the host), whole calls, so
``tokens_per_s`` counts no part of a call.

The outcome's ``facts``: ``tokens_in_window`` and ``steps_in_window`` (the
tokens generated and the decode steps of the window's calls),
``call_shape`` (batch, prompt, generated), ``traced_steps`` (the traced
call's decode steps) and ``warm`` (the warm-up call's prompts, tokens and
logits).
"""

from __future__ import annotations

import gc
import sys
import time
import traceback

import numpy as np

from harness.cell import Context, Outcome
from harness.trace import Tracer


def run(ctx: Context, seconds: float, trace: bool) -> Outcome:
    import torch

    from repro_torch.launch import serve

    served, tr = ctx.engine, ctx.traffic
    b, p, g, max_seq = (int(tr[k]) for k in ("batch", "prompt", "gen", "max_seq"))
    if min(p, tr["warm_prompt"], tr["trace_prompt"]) < 1:
        raise ValueError("a call needs a prompt of at least one id")
    vocab = served.cfg.vocab_size

    def draw(n: int) -> np.ndarray:
        return ctx.rng.integers(0, vocab, (b, n)).astype(np.int32)

    def call(prompts: np.ndarray, gen: int) -> np.ndarray:
        ids = torch.from_numpy(prompts).to(served.device)
        return serve.generate(served.cfg, served.params, ids, gen, max_seq=max_seq).cpu().numpy()

    # The warm-up call, each decode step's logits kept as generate gets them.
    steps = []
    decode = serve.decode

    def kept(*args, **kw):
        logits, cache = decode(*args, **kw)
        steps.append(logits.float().cpu())
        return logits, cache

    warm_prompts = draw(int(tr["warm_prompt"]))
    t = time.perf_counter()
    serve.decode = kept
    try:
        warm_tokens = call(warm_prompts, int(tr["warm_gen"]))
    finally:
        serve.decode = decode
    print(f"warm-up call: {time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
    warm = {"prompts": warm_prompts, "tokens": warm_tokens,
            "logits": torch.stack(steps, 1) if steps else None}
    del steps

    answers, spans, failed = [], [], 0
    prompts = draw(p)
    gc.collect()         # every run enters its window from the same collector state
    ctx.window_start = t0 = time.perf_counter()
    t_end = t0 + seconds
    while not spans or time.perf_counter() < t_end:
        s = time.perf_counter()
        try:
            tokens = call(prompts, g)
        except Exception:
            if not failed:
                traceback.print_exc(file=sys.stderr)
            failed += 1
            tokens = None
        spans.append((s, time.perf_counter()))
        if tokens is not None:
            answers.append((prompts, tokens))
        prompts = draw(p)
    done = len(answers)
    print(f"window: {len(spans)} calls of " + ", ".join(f"{e - s:.3f}" for s, e in spans) + " s",
          file=sys.stderr, flush=True)

    trace_data, traced_steps = None, None
    if trace:
        tp = draw(int(tr["trace_prompt"]))
        tracer = Tracer()
        tracer.start()
        tt = call(tp, int(tr["trace_gen"]))
        trace_data = tracer.stop()
        answers.append((tp, tt))
        traced_steps = tp.shape[1] + tt.shape[1]
    return Outcome(
        attempted=len(spans), failed=failed, missing=0, answers=answers,
        window_s=spans[-1][1] - spans[0][0], trace=trace_data,
        facts={"tokens_in_window": done * b * g, "steps_in_window": done * (p + g),
               "call_shape": (b, p, g), "traced_steps": traced_steps, "warm": warm},
    )
