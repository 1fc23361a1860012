"""Single-card launchers of the port."""
