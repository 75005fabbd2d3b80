"""End to end, batch cells: 1e-6 x channels x input samples of every
call completed in the window, over the window (its start to the end of
the synchronise after the last call), on the host's clock."""


def read(run):
    w = run.window
    return 1e-6 * w.channels * w.item_len * w.items / w.seconds
