"""Multi-process data parallelism: ``multihost`` (the process group, its
collectives, this process's rows), ``mesh`` (the data-parallel width) and
``dryrun`` (the CLI in N local processes)."""
