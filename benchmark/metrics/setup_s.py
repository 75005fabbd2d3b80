"""End to end, every cell: seconds from the process's start (the first
statement of ``run.py``) to the first timed call: imports, the host
design and operators, the inputs and the warm-up."""


def read(run):
    return run.setup_s
