"""The benchmark's plain reference of the LCGP model and its data.

Plain PyTorch and NumPy, written from the model's equations: it imports
nothing of the package under test (nor of the JAX package beside it) and
takes nothing that package computed.  ``lcgp_ref`` holds the model,
``data`` the seeded data generators.
"""
