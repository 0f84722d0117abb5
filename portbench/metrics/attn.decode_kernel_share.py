"""attn.decode_kernel_share: the share of the traced call's attention
layer steps that ran the decode attention kernel (``csrc/gqa_decode.cu``),
in percent: the device rows whose names hold ``gqa_decode`` over the
call's steps times the configuration's layers.  Read only for an
``lm_decode`` configuration, a dense decoder whose every layer attends
over its KV cache (``harness/lm_reference.py`` builds one attention block
a layer); nothing for a configuration of another system, whose layers
are of other kinds.  Read from the device rows, since under a replayed
CUDA graph the program's own counts move only at the capture.  0 where
the attention ran in torch operations (a program without the kernel);
nothing without a trace or the call's shape."""

KERNEL = "gqa_decode"


def read(rec):
    tr, steps = rec.trace, rec.facts.get("traced_steps")
    layers = rec.cfg.get("n_layers")
    if (rec.cfg.get("system") != "lm_decode" or tr is None or not steps
            or rec.facts.get("call_shape") is None or not layers):
        return None
    rows = sum(1 for n, _, _ in tr.device if KERNEL in n)
    return 100.0 * rows / (steps * layers)
