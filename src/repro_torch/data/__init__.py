"""Synthetic federated data (host-side numpy, bitwise equal to `repro.data`)."""
