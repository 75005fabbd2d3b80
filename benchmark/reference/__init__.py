"""The benchmark's plain reference: float64 PyTorch over a frozen plan.

``plan.py``, ``design/`` and ``utils/`` are a frozen copy of the host
design of ``r8brain_torch`` (its planner and filter design, pure NumPy):
they work the stage chain and every filter out again from a
configuration's arguments, so the reference takes nothing the program
made.  ``chain.py`` runs that plan from each stage's content formula
(the semantics of the CPU oracle, ``r8brain_torch/models/oracle.py``),
batched over rows and on absolute sample ranges, so that it can check a
oneshot and any stretch of a stream alike.  Nothing here imports the
program.
"""

from .chain import Chain, stage_out_len, work_counts
from .plan import make_plan

__all__ = ["Chain", "make_plan", "stage_out_len", "work_counts"]
