"""End to end, stream cells: 1e-6 x streams x input samples of every
block completed in the window, over the window, on the host's clock."""


def read(run):
    w = run.window
    return 1e-6 * w.channels * w.item_len * w.items / w.seconds
