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

__all__ = ["resolve_device"]


def __getattr__(name):
    # lazy, so the host processes (store, result store, agents, web, CLI,
    # the host benches' children) import no torch
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(name)
