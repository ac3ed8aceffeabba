"""Seconds from the harness's start to the window's start: imports, the
card, generation, ingest, warming, the kernels' build where it runs, and
the warm-up batches."""


def read(run):
    return run.setup_s
