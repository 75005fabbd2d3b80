"""Planner, length algebra and the batched resampler front-end."""

from .plan import Plan, make_plan
from .resampler import Resampler, Resampler16, Resampler16IR, Resampler24
