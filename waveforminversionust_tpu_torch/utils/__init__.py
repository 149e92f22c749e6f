"""Host-side utilities of the port: checkpoints, host transfers, timing
and profiling spans, and the cost models with their roofline."""
