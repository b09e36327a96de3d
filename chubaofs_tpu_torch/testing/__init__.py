"""Test harnesses (blobstore/testing + docker/ compose-scripts analog)."""
