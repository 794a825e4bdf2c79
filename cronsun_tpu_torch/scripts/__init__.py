"""Benchmarks of the port, run as modules:
``python -m cronsun_tpu_torch.scripts.bench_sched`` and
``python -m cronsun_tpu_torch.scripts.bench_mesh``."""
