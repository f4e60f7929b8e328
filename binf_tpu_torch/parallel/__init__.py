"""Multi-chain execution.  Ported so far: ``runner.init_chains``,
``runner.run_chains``, ``runner.warmup_and_run`` and
``runner.per_chain_step_size_kernel``; meshes and collectives come with
``parallel/mesh.py`` and ``parallel/collectives.py``, not ported yet
(ROADMAP section 1)."""
