"""The benchmark harness: cells found by name, the run, the trace and
the check."""
