"""Device, held back by the program's host code: the share, %, of the
traced window in which no operation ran on the device and the idle gap
began while one of the program's ``r8b.*`` spans was open on the main
thread (the rest of ``idle_pct.stream`` begins in the benchmark's loop or
its synchronise)."""

from benchmark.harness.program import idle_in_spans_s


def read(run):
    tr = run.trace
    if tr is None or run.kind != "stream" or tr.window_s <= 0 or not tr.ops:
        return None
    idle = idle_in_spans_s(tr)
    return None if idle is None else 100 * idle / tr.window_s
