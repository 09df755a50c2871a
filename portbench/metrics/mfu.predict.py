"""The whole step's share of the card's dense bf16 peak (predict cells):
analytic FLOPs of every image the traced window completed
(arith/flops.py) over the window, the cards and the published peak of
the card by name (arith/peaks.py); none for an unknown card."""

from portbench.metrics._shares import mfu


def read(run: dict):
    return mfu(run, "predict")
