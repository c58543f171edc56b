"""Compiled programs: per training step, ms in which the device is idle
while the host is inside the replay's ``mrt.jit.key``, ``mrt.jit.copy_in``
or ``mrt.jit.outputs`` span (the program's own ranges), from the trace."""

from portbench.harness.spans import host_idle_ms as read  # noqa: F401
