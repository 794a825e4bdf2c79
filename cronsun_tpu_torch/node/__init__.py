"""Node-side runtime: executor, process registry, agent.

Copy of ``cronsun_tpu/node/__init__.py``.
"""

from .executor import ExecResult, Executor  # noqa: F401
