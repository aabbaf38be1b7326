"""The reference side of each stage in :mod:`portbench.stages`, one module
each under the same name: ``numbers(inputs, calls, rng, device, sample,
control=False)`` works out again what the sampled calls of the window
produced and returns each number compared (with ``control``, the reference
in TF32 stands in the program's place).  Plain PyTorch and NumPy: nothing here
imports the program or JAX."""
