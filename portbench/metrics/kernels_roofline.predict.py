"""The hand kernels' share of their roofline (predict cells): the sum of
their bound times (arith/kernels.py: bytes at the step's shapes over
the card's memory bandwidth) over the sum of their device times in the
traced window, by kernel name."""

from portbench.metrics._shares import roofline


def read(run: dict):
    return roofline(run, "predict")
