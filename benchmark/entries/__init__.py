"""Entries: one module per kind of call the window drives, found by the
``entry`` name of a traffic file.  Each defines ``Entry(cfg, traffic, seed,
device, root)`` with ``setup()``, ``instrument(reservoir, span)``,
``run_unit(i)``, ``captured(kept, exp, mode)`` (the kept batches in the
form the decode mode's ``compare`` reads) and ``release()``."""
