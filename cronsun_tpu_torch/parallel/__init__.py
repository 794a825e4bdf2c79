"""Mesh planners and the multi-host sync of the port (counterpart of
``cronsun_tpu.parallel``): :mod:`.mesh` (the 1-D and 2-D mesh planners over
lists of torch devices), :mod:`.collectives` (the exchanges between their
shards) and :mod:`.hostsync` (the op-log broadcast of a mesh that spans
processes, on ``torch.distributed``)."""

from .mesh import (Mesh, Sharded2DTickPlanner, ShardedTickPlanner,  # noqa: F401
                   make_mesh, make_mesh2d)
