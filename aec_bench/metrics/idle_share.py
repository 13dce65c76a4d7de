"""The share of the traced window in which no operation ran on the card."""


def read(r):
    t = r["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
