"""The benchmark of horovod_tpu_torch on NVIDIA cards.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m hvdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it (:mod:`hvdbench.spec`).  Nothing here imports JAX or the JAX
package; the plain references import nothing of ``horovod_tpu_torch``.
"""
