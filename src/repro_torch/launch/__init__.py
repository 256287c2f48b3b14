"""Launchers of the port (the serving launcher; the others are to come)."""
