"""Device: 100 x (1 - busy / wall) over the traced window, in the render
cells."""

from portbench.harness.readers import device_idle_pct as read  # noqa: F401
