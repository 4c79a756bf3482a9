"""The plain reference of the memory experiment, for the benchmark's check.

Plain NumPy and PyTorch, independent of the program under test: it imports
neither ``jax`` nor either package of the repository.  It builds its own
matrices from the code's checks (the spacetime matrix, (H|I), priors,
syndromes, a basis of logical operators), models the phenomenological
noise of the experiment exactly (the expected rate of every measured bit),
and decodes with min-sum BP and OSD-CS in the numerics the configuration
states.
"""
