"""Production entrypoints of the port (counterparts of ``cronsun_tpu/bin/``).

Each is a real OS process wired through conf + logging + the event bus,
talking to the coordination store over TCP:

    python -m cronsun_tpu_torch.bin.store --port P     # coordination store
    python -m cronsun_tpu_torch.bin.logd --port P      # result store
    python -m cronsun_tpu_torch.bin.sched --store H:P  # leader scheduler
    python -m cronsun_tpu_torch.bin.node --store H:P   # execution agent
    python -m cronsun_tpu_torch.bin.web --store H:P    # REST API + noticer

A fleet may mix them with the JAX package's processes
(``cronsun_tpu.bin.*``) or the native daemons: the wire is the same.
Only the scheduler does device work.
"""
