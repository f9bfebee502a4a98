"""How the program under test is set up, one module a preset, found by
the ``preset`` name of a configuration file.  Each module's
``build(problem, config, device)`` hands the benchmark's CSR arrays to
``tpu_amg_torch`` and returns its solver: an object whose
``solve(b, x0, *, rtol, maxiter)`` returns ``(x, info)`` with
``info.iters``, ``info.converged`` and ``info.final_res`` (‖r‖₂ as the
solver's loop last read it), and whose ``op`` and ``preconditioner`` the
per-layer metrics time.
"""
