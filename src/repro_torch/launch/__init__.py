"""Launchers of the port: serving (``serve``), training (``train``), the
production meshes (``mesh``), the dry run of every cell on ``meta``
(``specs``, ``dryrun``) with its cost reader (``cost_analysis``),
roofline (``roofline``) and table (``report``)."""
