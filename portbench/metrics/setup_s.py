"""Seconds from the process's start to the first timed call: imports,
builds or cache loads of the kernels, inputs, tables and warm-up."""

UNIT = "s"


def read(run):
    return run.setup_s
