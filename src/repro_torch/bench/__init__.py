"""The port's benches, one module per reference bench under
``benchmarks/``: each ``run(...)`` returns the same derived keys as its
reference counterpart.  The budget (``mode``), the MSE path and the device
are arguments rather than environment variables."""
