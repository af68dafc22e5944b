"""Model package of the port: the dense transformer on the serving path."""
