"""decode.replay_share: the share of the traced call's decode steps that
replayed a captured CUDA graph, in percent: the program's
``decode.replay`` spans (one a replayed step) that start in the traced
window, over the call's steps.  0 where the call's steps ran eagerly (a
program that opens no such span); nothing without a trace."""

REPLAY = "decode.replay"


def read(rec):
    tr, steps = rec.trace, rec.facts.get("traced_steps")
    if tr is None or not steps:
        return None
    replays = sum(1 for n, s, _ in tr.host if n == REPLAY and tr.start_us <= s <= tr.end_us)
    return 100.0 * replays / steps
