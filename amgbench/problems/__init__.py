"""Problem generators, one module a generator, found by the ``generator``
name of a configuration file.  Each module's ``make(config)`` returns the
matrix as host CSR arrays (``indptr`` int64, ``indices`` int32, ``data``
float64, sorted columns, duplicates summed), which the benchmark hands
alike to the program under test and to the plain reference.
"""
