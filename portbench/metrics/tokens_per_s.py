"""tokens_per_s: tokens generated by the calls that started in the window,
over the seconds from the first of those calls' start to the last one's
end (whole calls: no call is counted in part)."""


def read(rec):
    if rec.facts.get("tokens_in_window") is None:
        return None
    return rec.facts["tokens_in_window"] / rec.window_s
