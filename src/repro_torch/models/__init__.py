"""Model families: the dense and moe transformer, the ssm, hybrid, vlm and
audio families, and the architecture registry."""
