"""Samplers.  So far only the warmup schedule the fused warmup kernel
shares (``adaptation._stan_boundaries``) is ported."""
