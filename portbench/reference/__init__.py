"""The plain fp32 reference and the comparisons that decide ``correct``.
Imports neither JAX, nor the JAX package, nor anything of the port."""
