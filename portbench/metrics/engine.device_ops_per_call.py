"""engine.device_ops_per_call: operations on the card (kernels, copies,
memsets) in the traced window over the engine calls traced; the
adaptive booleanize's launches show here."""


def read(rec):
    if rec.trace is None or not rec.traced_calls or not rec.trace.device:
        return None
    return len(rec.trace.device) / len(rec.traced_calls)
