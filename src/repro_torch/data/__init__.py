"""The LM's synthetic data pipeline (`pipeline`)."""
