"""The benchmark of the PyTorch and CUDA port (``fcn8s_tensorflow_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on this machine's
card(s); see ``portbench/run.py``. Nothing here imports JAX or the JAX
package, and ``portbench/reference/`` imports nothing of the port.
"""
