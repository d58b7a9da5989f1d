"""First-order optimizers (the FO baseline's)."""
