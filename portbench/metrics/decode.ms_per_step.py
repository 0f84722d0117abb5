"""decode.ms_per_step: the window's seconds (its calls, back to back, from
the first one's start to the last one's end) over the decode steps of
those calls (prompt and generated positions), in milliseconds."""


def read(rec):
    steps = rec.facts.get("steps_in_window")
    if not steps:
        return None
    return rec.window_s * 1e3 / steps
