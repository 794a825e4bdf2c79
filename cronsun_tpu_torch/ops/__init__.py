"""Batched scheduling ops on PyTorch tensors (counterpart of ``cronsun_tpu.ops``).

- :mod:`timecal` — host-side calendar decomposition (numpy copy).
- :mod:`eligibility` — bitpacked job x node placement masks (numpy copy).
- :mod:`schedule_table` — compiled specs as a dataclass of column tensors.
- :mod:`tick` — the [J, W] fire mask.
- :mod:`kernels` — the bid and fan-out wrappers: hand-written CUDA kernels
  on the card, plain PyTorch on the CPU.
- :mod:`assign` — load-balanced capacity-constrained job->node assignment.
- :mod:`planner` — ``TickPlanner``: device state plus the windowed plan.

Nothing is imported here, so ``import cronsun_tpu_torch.ops.timecal`` stays
as light as the module itself.
"""
