"""Command-line entry points of the port: ``serve`` (the serving engine),
``train`` (smoke and production training), ``dryrun`` (each production
step traced on meta tensors as one rank of the production meshes: per-chip
FLOPs, bytes, collectives, memory and roofline terms, without XLA);
``mesh`` builds the meshes (and a fake world of their size),
``step_cost`` counts a step as it runs and ``hlo_analysis`` holds the
roofline formulas."""
