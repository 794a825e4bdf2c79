"""The benchmark of the PyTorch and CUDA port (``cronsun_tpu_torch``).

``python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once (see ``__main__``).  The
yardstick lives here: the generator of the inputs (:mod:`.gen`), the plain
reference that decides ``correct`` (:mod:`.reference`), the cell runners,
the trace reader, the peaks and byte model (:mod:`.roofline`) and one
reader a metric under ``metrics/``.
"""
