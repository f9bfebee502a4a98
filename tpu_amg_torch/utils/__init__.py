"""Problem generators, checkpoints, I/O, reordering, stats, the solver
test harness, the 1-D geometric multigrid and device timing."""
