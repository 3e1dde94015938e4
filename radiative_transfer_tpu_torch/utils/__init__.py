"""Host-side runtime utilities: CSV output and step-rate accounting."""
