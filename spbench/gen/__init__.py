"""Matrix generators, one module a generator: ``generate(seed, **args)``
returns a ``scipy.sparse.csc_matrix`` with sorted, summed indices."""
