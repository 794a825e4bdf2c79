"""The mesh's collectives, between the shards of one axis group.

A mesh planner holds one set of tensors per shard and runs each step of a
tick shard by shard; between the steps the shards exchange values through
the named functions here, the counterparts of the ``jax.lax`` collectives
the reference calls inside ``shard_map``:

- :meth:`Collectives.all_gather` along an axis: the values of the shard's
  axis group, stacked in shard order ([G, ...]) on the shard's device;
- :meth:`Collectives.psum` along an axis: that stack summed in shard order,
  one add at a time, so every shard computes the identical float on any
  device;
- :meth:`Collectives.axis_index`: a shard's coordinate along an axis.

In one process every shard's value is at hand.  A multi-host mesh
(``process_count > 1``) first gathers every process's local values with one
``torch.distributed.all_gather`` over gloo, on host tensors:
:func:`stage_to_host` is the one place device values are copied to (pinned)
host memory for the wire.  The step then finishes in process, as above.

Each call counts the bytes it moved in :attr:`Collectives.moved`, under
``estimate_collective_bytes``' convention: the gathered output size for an
all_gather (what each device materializes), the payload once for a psum.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def stage_to_host(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """[L, ...] host copy of ``xs`` (one value per local shard, one shape):
    pinned and copied without blocking when a value is on the card, then
    synchronised with every card the values were on."""
    cards = {x.device for x in xs if x.device.type == "cuda"}
    host = torch.empty((len(xs), *xs[0].shape), dtype=xs[0].dtype,
                       pin_memory=bool(cards))
    for i, x in enumerate(xs):
        host[i].copy_(x, non_blocking=bool(cards))
    for d in cards:
        torch.cuda.synchronize(d)
    return host


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class Collectives:
    """Collectives of ``mesh`` over lists of per-shard values, in the order
    of ``mesh.local`` (this process's shards)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.moved = 0

    def axis_index(self, s: int, axis: str) -> int:
        """The coordinate along ``axis`` of local shard ``s``."""
        return self.mesh.coords(self.mesh.local[s])[
            self.mesh.axis_names.index(axis)]

    def everyone(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's value, in global shard order.  Local values stay
        where they are; other processes' values arrive on the host (bool
        rides the wire as uint8)."""
        m = self.mesh
        if m.process_count == 1:
            return list(xs)
        import torch.distributed as dist
        host = stage_to_host(xs)
        wire = host.view(torch.uint8) if host.dtype == torch.bool else host
        parts = [torch.empty_like(wire) for _ in range(m.process_count)]
        dist.all_gather(parts, wire)
        out: List[torch.Tensor] = []
        for p in parts:
            out.extend((p.view(torch.bool) if host.dtype == torch.bool
                        else p).unbind(0))
        for s, g in enumerate(m.local):
            out[g] = xs[s]
        return out

    def _stacks(self, xs, axis) -> List[torch.Tensor]:
        """Per local shard, its axis group's values stacked in shard order on
        its device (one stack per group and device, shared read-only)."""
        vals = self.everyone(xs)
        cache: Dict[tuple, torch.Tensor] = {}
        out = []
        for s, g in enumerate(self.mesh.local):
            grp = tuple(self.mesh.group(g, axis))
            dev = xs[s].device
            if (grp, dev) not in cache:
                cache[grp, dev] = torch.stack([vals[h].to(dev) for h in grp])
            out.append(cache[grp, dev])
        return out

    def all_gather(self, xs: Sequence[torch.Tensor],
                   axis: str) -> List[torch.Tensor]:
        """Per local shard, [G, ...]: the values of its ``axis`` group in
        shard order (the reference's ``all_gather``; ``reshape(-1)`` of it
        is ``tiled=True``)."""
        out = self._stacks(xs, axis)
        self.moved += out[0].shape[0] * _nbytes(xs[0])
        return out

    def psum(self, xs: Sequence[torch.Tensor],
             axis: str) -> List[torch.Tensor]:
        """Per local shard, the sum over its ``axis`` group, added in shard
        order."""
        cache: Dict[int, torch.Tensor] = {}
        out = []
        for st in self._stacks(xs, axis):
            if id(st) not in cache:
                acc = st[0]
                for i in range(1, st.shape[0]):
                    acc = acc + st[i]
                cache[id(st)] = acc
            out.append(cache[id(st)])
        self.moved += _nbytes(xs[0])
        return out
