"""Planner, length algebra, the batched resampler front-end and the
push-mode stream."""

from .plan import Plan, make_plan
from .resampler import Resampler, Resampler16, Resampler16IR, Resampler24
from .stream import StreamResampler
