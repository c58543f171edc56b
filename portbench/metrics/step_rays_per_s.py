"""W x H x B rays of every training step completed in the window, over
the window's seconds (host clock)."""

from portbench.harness.readers import rate as read  # noqa: F401
