"""setup_s: process start to the first timed request, in seconds (the
torch import, the card's context, the kernels' build or load, the inputs
and the model, the warm-up of the cell's buckets)."""


def read(rec):
    return rec.setup_s
