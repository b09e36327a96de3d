"""The erasure-coded blob store. This slice carries only trace.py, the span
machinery CodecService attributes its host/device stages to."""
