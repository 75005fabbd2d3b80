"""Host-side analysis utilities (FIR response, response scanners, math,
tracing)."""
