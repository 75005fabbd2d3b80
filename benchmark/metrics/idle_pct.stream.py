"""Device: the share, %, of the traced window in which no operation ran
on the device (1 - the union of the operations' intervals over the
window)."""


def read(run):
    if run.trace is None or run.kind != "stream" or run.trace.window_s <= 0 \
            or not run.trace.ops:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
