"""Plain references of the benchmark's configurations, in PyTorch and NumPy
only: the same mathematics as the port's timed path, written from the
configuration's equations, importing nothing of the port and nothing of
JAX. ``<config>.py`` is the reference of one configuration; the other
modules are the plain pieces they share."""
