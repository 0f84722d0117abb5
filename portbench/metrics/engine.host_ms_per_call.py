"""engine.host_ms_per_call: the mean host time of one
``ServingEngine.dispatch`` call in the window (validation, bucket, pinned
copy-in, the launches of ingress and clause kernels), on the benchmark's
clock around the call."""


def read(rec):
    if rec.dispatch_s is None or len(rec.dispatch_s) == 0:
        return None
    return float(rec.dispatch_s.mean()) * 1e3
