"""Single-card forms of the reference's distributed pieces."""
