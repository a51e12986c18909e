"""repro_torch.launch — the LM dry run over H100 cluster meshes (the port
of ``repro.launch``): production meshes and rules (:mod:`.mesh`), the
sharded step builders (:mod:`.specs`) and the command
(``python -m repro_torch.launch.dryrun``, :mod:`.dryrun`).  Importing it
opens no process group: only the dry run's command does."""
