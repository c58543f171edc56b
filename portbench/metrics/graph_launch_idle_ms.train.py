"""Compiled programs: per training step, ms in which the device is idle
while the host is inside ``cudaGraphLaunch`` (the replay's launch of the
captured graph), from the trace."""

from portbench.harness.readers import graph_launch_idle_ms as read  # noqa: F401
