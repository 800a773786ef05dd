# Launchers of the port: LM serving (``serve``).  The JAX package's mesh
# factory, dry-run, roofline and train launchers are not ported yet.
