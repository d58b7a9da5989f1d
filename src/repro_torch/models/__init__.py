"""Model families (dense decoder-only transformer in this port)."""
