"""The yardstick's arithmetic: analytic FLOPs, the card's peaks, interval
unions, and the hand kernels' bytes, as functions of shapes."""
