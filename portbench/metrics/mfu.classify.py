"""mfu.classify: the word tests that the classifications completed in the
window need, over the window's seconds times the card's 32-bit integer
rate, in percent: the whole classify step's share of the card's peak."""

from harness.readers import classify_mfu_pct


def read(rec):
    return classify_mfu_pct(rec)
