"""Model configurations of the port (see ``registry.ARCHS``)."""
