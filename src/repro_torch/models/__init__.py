"""Model definitions of the port (dense 'G'-layer archs in this slice)."""
