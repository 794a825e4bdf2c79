"""Batched scheduling ops on PyTorch tensors (counterpart of ``cronsun_tpu.ops``).

- :mod:`timecal` — host-side calendar decomposition (numpy copy).
- :mod:`eligibility` — bitpacked job x node placement masks (numpy copy).
- :mod:`schedule_table` — compiled specs as a dataclass of column tensors.
- :mod:`tick` — the [J, W] fire mask and batched next-fire.
- :mod:`kernels` — the bid and fan-out wrappers: hand-written CUDA kernels
  on the card, plain PyTorch on the CPU.
- :mod:`assign` — load-balanced capacity-constrained job->node assignment.
- :mod:`deps` — the workflow-DAG trigger.
- :mod:`tenancy` — token-bucket admission and weighted max-min fair share.
- :mod:`planner` — ``TickPlanner``: device state plus the windowed plan.
"""

from .schedule_table import FRAMEWORK_EPOCH, ScheduleTable  # noqa: F401
from .tick import fire_mask, next_fire  # noqa: F401
