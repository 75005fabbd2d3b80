"""Host-side analysis utilities (FIR response, math, tracing)."""
