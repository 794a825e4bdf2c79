"""Production entrypoints of the port (counterparts of ``cronsun_tpu/bin/``).

Each is a real OS process wired through conf + logging + the event bus,
talking to the coordination store over TCP:

    python -m cronsun_tpu_torch.bin.sched --store H:P   # leader scheduler

The store, agent, web and result-store processes stay the JAX
package's (``cronsun_tpu.bin.*``) or the native daemons; the wire is the
same.
"""
