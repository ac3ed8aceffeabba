"""Host planning per batch (ms): the benchmark's host-clock span around
the model's query compiler (``compile_queries`` or ``plan_bucket``), mean
over the traced window's batches."""


def read(run):
    return 1e3 * sum(run.plan_s) / len(run.plan_s) if run.plan_s else None
