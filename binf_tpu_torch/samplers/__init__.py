"""Samplers.  Ported so far: the fused whole-run entry point
``fused.fused_model_hmc`` (``warmup="fused"``), the Halton table of
``chees``, and the warmup schedule the fused warmup kernel shares
(``adaptation._stan_boundaries``)."""
