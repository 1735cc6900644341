"""The deterministic synthetic data stream (numpy)."""
