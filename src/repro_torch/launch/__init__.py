"""Command-line entry points of the port: ``serve`` (the serving engine),
``train`` (smoke and production training), ``dryrun`` (per-chip bytes and
roofline terms on the production meshes, without XLA); ``mesh`` builds
the meshes and ``hlo_analysis`` holds the roofline formulas."""
