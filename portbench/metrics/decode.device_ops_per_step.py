"""decode.device_ops_per_step: operations on the card (kernels, copies,
memsets) in the traced call over its decode steps."""


def read(rec):
    steps = rec.facts.get("traced_steps")
    if rec.trace is None or not steps or not rec.trace.device:
        return None
    return len(rec.trace.device) / steps
