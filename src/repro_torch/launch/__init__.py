"""Launcher of the port: the step functions and their sharding
(``steps``), the static-batching serving loop (``serve``), the trainer
(``train``), the production mesh (``mesh``) and the dry-run (``dryrun``)."""
