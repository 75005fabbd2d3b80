"""Multi-device execution helpers (only the chain algebra so far)."""

from .sharding import chain_input_span, chain_shift_period
