"""Multi-device execution helpers (only the shift-period algebra so far)."""

from .sharding import chain_shift_period
