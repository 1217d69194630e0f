"""Utilities: phase timing, log-bucketed histograms, the flight recorder."""
