"""Compiled programs: host seconds of the keys' captures (static inputs,
capture, instantiation), the device synchronised on both sides, from the
program's ``jit.COUNTS``."""

from portbench.harness.spans import first_call_s

read = first_call_s("capture")
