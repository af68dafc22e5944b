"""Plain references, one module per kind of model, named by a
configuration file's ``reference`` key."""
