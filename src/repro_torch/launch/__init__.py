"""Launchers of the port: serving (``serve``) and training (``train``)."""
