"""The port's synthetic data pipeline (ROADMAP queue 1 item 13d)."""
