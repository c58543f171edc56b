"""W x H x B x frames rays of every image completed in the window, over
the window's seconds (host clock)."""

from portbench.harness.readers import rate as read  # noqa: F401
