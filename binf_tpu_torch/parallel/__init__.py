"""Multi-chain execution.  Ported so far: ``runner.init_chains`` and
``runner.run_chains``; meshes and collectives wait for ROADMAP section 1,
item 11."""
