"""Operator tools: cfs-stat, the /metrics scrape-and-diff CLI, and cfs-doctor,
which lists, inspects and diffs incident flight-recorder bundles."""
