"""Model modules, one per form of model, named by a configuration file's
``model`` key (``transformer`` when it has none); ``transformer.py`` lists
what a module provides."""
