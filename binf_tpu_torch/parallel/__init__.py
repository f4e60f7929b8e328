"""Multi-chain execution.  Ported so far: ``runner.init_chains``,
``runner.run_chains``, ``runner.warmup_and_run`` and
``runner.per_chain_step_size_kernel``; the production driver
``production.run_blocks`` and ``production.run_fused_blocks`` (blocks,
checkpoints, bitwise resume).  Meshes and collectives come with
``parallel/mesh.py`` and ``parallel/collectives.py``, not ported yet
(ROADMAP section 1)."""
