"""Host-side runtime utilities: CSV output, checkpointing, diagnostics,
profiling, numeric guards."""
