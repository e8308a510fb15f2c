"""Shuffle: device-side partitioning and the in-process block store."""
