"""Queries completed in the window over the window's length (queries/s)."""


def read(run):
    return run.queries_done / run.window_s if run.window_s > 0 else None
