"""The harness: files by name, the generator and loops, the traced run,
the work count and the comparison that decides ``correct``."""
