"""Shared utilities: locks, metrics, config, audit log, events, trace sink."""
