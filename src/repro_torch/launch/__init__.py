# Launchers of the port: the mesh factory, the dry run and its roofline,
# and the train and serve drivers.  ``dryrun`` creates its fake process
# group only when called, never at import.
