"""PyTorch/CUDA port of cronsun-tpu's device planner.

The package mirrors ``cronsun_tpu``'s layout (``cron/``, ``ops/``) so each
module has a named counterpart, but it imports neither JAX nor anything of
``cronsun_tpu``: what it shares with the JAX package (the cron parser, the
calendar decomposition, the eligibility packer) it keeps as its own copies.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit CPU request they raise
(:func:`cronsun_tpu_torch.device.resolve_device`).  On the card the two hot
steps of the plan run as hand-written Hopper kernels (``csrc/``); on the
CPU the same wrappers run their plain PyTorch versions.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
