"""Compiled programs: MiB copied into the graph's static inputs per
replay, from the program's ``jit.COUNTS`` over every replay of the run,
in the train cells."""

from portbench.harness.spans import copy_in_mib as read  # noqa: F401
