"""The card's idle share of the traced window (train cells): 100 x (1 - the
union of the device events' intervals inside the window over the window)."""

from portbench.metrics._shares import idle


def read(run: dict):
    return idle(run, "train")
