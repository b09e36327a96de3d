"""Operator tools: cfs-stat, the /metrics scrape-and-diff CLI."""
