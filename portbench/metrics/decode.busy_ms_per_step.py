"""decode.busy_ms_per_step: the time in which an operation ran on the card
during the traced call (overlaps merged), over its decode steps, in
milliseconds."""


def read(rec):
    steps = rec.facts.get("traced_steps")
    if rec.trace is None or not steps or not rec.trace.device:
        return None
    return rec.trace.busy_s * 1e3 / steps
