"""Planner, length algebra, the float64 host oracle, the batched
resampler front-end and the push-mode stream."""

from .oracle import OracleResampler
from .plan import Plan, make_plan
from .resampler import Resampler, Resampler16, Resampler16IR, Resampler24
from .stream import StreamResampler
