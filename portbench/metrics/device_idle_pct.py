"""Share of the traced window in which no operation runs on the device
(100 - the union of device intervals over the window), in %."""


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
