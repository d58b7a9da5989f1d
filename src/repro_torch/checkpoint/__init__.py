"""Crash-safe checkpoints and resume, ported from `repro.checkpoint`."""
