"""Drive the PyTorch/CUDA port (tpu_amg_torch) once on one GPU and check it.

Usage: python3 chip_smoke.py [--side 48] [--elasticity-side 40] [--reps 50]

Phases, one printed line per result; any failed check exits non-zero:
  1. device: nvidia-smi's name and power limit, torch / CUDA / nvcc / g++;
  2. builds: the six CUDA kernel libraries (nvcc: K1 + K2, K3 (its
     three designs), the
     stream probe, K1's stage ablations, the copy probe, the primitive
     probe) and the native host library (g++), from the sources in this
     checkout, all seven compilers started together, and beside them
     ptxas's report of csrc/dia.cu (nvcc -Xptxas -v): K3's row-chunk
     kernel's registers at every pair, k and R, none may spill;
  3. K1/K2 vs their plain PyTorch versions on the card: a random
     heavy-row matrix with a small cap; A0 of unstructured_poisson_3d(64)
     (262,144 rows, past the L2 at k=1) at k=1, whatever --side is: the
     kernels line's K1 reading; then every A, P and R of the SA
     path's hierarchy that K1 ran on (and all of levels 0 and 1); mv and
     mm (k=8, every k the SA path ran on that matrix, and for A0 the
     bootstrap's k=7), float64 and float32; errors, two K2 calls bitwise
     equal, the tail's rows and longest row, and the device's
     time per call: CUDA events around the replay of a CUDA graph of 50
     calls (median of 5 replays); beside them, at every k, the library's
     own SpMV or SpMM (a torch sparse CSR tensor of the capped part, and
     of the tail, `@ x`) timed the same way, and the bound: the bytes
     each call must move over the 3,350 GB/s data sheet (for K2 also
     its first design's, a row id per entry); at k=1 also
     K1's first design (`rowgroup`); then
     K1's and K2's launches on the SA path by matrix, times (time -
     bound);
  4. SA path: AMGSolver.setup on unstructured_poisson_3d(side) (side 48,
     110,592 dofs, unless --side says otherwise) with the
     scalar 3-D SA config, then 3 PCG solves of A x = A x_true (seeded
     x_true) to rtol 1e-6, each eager (cg) and through AMGSolver.solve
     (compile: one iteration captured in a CUDA graph and replayed),
     which must give the same iterations, histories and, bitwise, x; one
     stationary solve to rtol 1e-6 (at most 200 iterations), eager and
     compiled, which must converge; the ||E||_A estimate (100 x 5, in
     (0, 1)) and ||E 1||_A / ||1||_A, E's factor on the constant vector
     (A 1 = 1e-8 1, the graph Laplacian's shift); the kernels' launch counts over that run (replays counted)
     must be > 0, and K1's and K2's are printed by (rows, cols, k); the
     V-cycle's time as the solve runs it (enqueued from Python) and the
     device's own time for it (graph replays); then the checkpoint saved,
     loaded, and its V-cycle bitwise equal to the original's;
  5. a small SA input solved on the card and, from the same hierarchy,
     on the CPU through the plain versions: the two must agree, and so
     must their ||E||_A estimates (10 power steps to 1e-10; 100, settled
     on the near-constant mode whose A-norm is a cancellation, to 2e-7);
  6. stream probe: its entry point (python -m
     tpu_amg_torch.tools.streambench, 32 MiB per call) with the launch
     count read over that run; then every case against its plain
     version (torch.sum over the view) on the same inputs (exact: they
     are integers), two calls bitwise equal, times and GB/s of both, the
     kernel's from the entry point's run; the single-input float32 cases
     again at 1 GiB per call, past the 50 MB L2: the read bandwidth of
     device memory, beside torch.sum's, and the copy probe's best
     configuration on as many bytes;
  7. structured path: build_structured_multigrid on poisson3d(100)
     (1,000,000 dofs) in float64 (DIA levels through K3),
     its levels, then 3 PCG solves of A x = A x_true to rtol 1e-6 and a
     stationary one, each eager and compiled as in phase 4; the
     launch counts over that run must be > 0, K2's printed by (rows,
     cols, k); the V-cycle's times;
  8. K3 vs its plain version at that path's level-0 and level-1
     operators, k = 1, 7, 8, float64 and float32, bitwise against its
     first design (K3 runs the row-chunk design below k = 8 and the
     band-tile design from k = 8 up; each design callable uncounted, the
     first design the reference) and against a second call, with
     the first design's time (taken in turns with K3's: A B B A), below
     k = 8 the band-tile design's, the row-chunk design's fixed cost of a
     launch (one diagonal, 4,096 rows, float32, k = 1),
     K1 + K2 on the same matrices as a capped CSR and the library's
     SpMV / SpMM from CSR storage beside it; K3's diagonal sweep (python
     -m tpu_amg_torch.tools.diasweep's: k = 64, float64, 262,144 rows,
     offsets {0}, {-1, 0, 1}, the adaptive A's 9 and -4..4, both designs,
     bitwise equal; the time per added diagonal against a diagonal's
     data at the HBM rate); K1/K2 vs their plain
     versions at the path's CSR level (level 2, outside the DIA
     envelope: every row spills to K2), k = 1, 8 and every k the path
     ran, float64 and float32, as in phase 3; then K2's launches on the
     structured path, times (time - bound);
  9. a small structured input on the card and on the CPU: the two must
     agree;
 10. stage ablation of K1: its entry point (python -m
     tpu_amg_torch.tools.wellablate) on unstructured_fem_system(1024)
     (1,048,576 rows, 7,339,948 entries) in float32, then the same modes
     in float64 on the SA path's A0, R0 and A1 from phase 4; every mode
     against its plain version, `full` bitwise equal to K1 on every
     matrix; `full` (= K1, the row-block design), `rowgroup` (K1's first
     design), the library's SpMV and the bound side by side;
 11. copy probes: the entry points python -m tpu_amg_torch.tools.dmabench
     (D1's sweep, both engines, 32 MiB per call, and the L2 read rate
     without a call's fixed cost: the larger slope of the time from 16
     to 32 MiB a call, of the sweep's best cases and stream_sum's) and
     dmabench2 (D2-D4, with the probe's fixed cost: its time on one 4 KB
     unit a block); every case against its plain version, exactly
     (integer inputs), over two calls; the sweep again at 1 GiB per
     call, past the 50 MB L2, and its best case against its plain
     version there; D2's and D4's bound (their bytes over the L2 read
     rate), the rate and its origin, the fixed cost and the share of
     the bound;
 12. primitives: the entry point python -m
     tpu_amg_torch.tools.microbench_primitives at 4096 tiles (ns per op
     against the issue-rate bound at the SM clock nvidia-smi reports,
     the HI call against the bound of its own 272 steps, each op's
     shared-memory wavefronts a warp gather, counted by a host model of
     the kernel's thread map, and the design floor they imply); every op
     against its plain version on the inputs it timed, at inner 16 and
     272; the SASS of the HI kernels (cuobjdump): every step's gathers
     issued inside the k loop (LDS, and SHFL.IDX for the pair's index
     gather), nothing spilled to local memory.
 13. the CLI: python -m tpu_amg_torch.tools.amg on the structured
     poisson3d(100) (--structured --tol 1e-6: cg_iters <= 14), the SA
     default aniso2d(256), the MFEM fixture that python -m
     tpu_amg_torch.tools.make_fem_fixture writes into a temporary
     directory, and the adaptive composite (--composite 2) on
     aniso2d(128) with random coefficients, its peel tables printed, and
     the structured elasticity (--problem elasticity3d --n 20, block
     size 3, 24,000 dofs), classical AMG (--interpolation classical
     --problem poisson2d --n 64 --smoother chebyshev: the auto W-cycle;
     --classical-opts tau=1.3,max=2 on aniso2d(16) with --coarsest-dim
     100, MEASURED.md:582's options on two levels); every final line
     parsed and checked, K1 (and K3 on the structured run) launched in
     each run, K1, K2 and K3 over the seven; python -m
     tpu_amg_torch.tools.profile_setup --side 128
     --top 15 (cProfile over a float32 setup with the float32 bootstrap:
     its top entries by own time, its phases, K1 at (f32, f32)); then the
     block smoother on the fixture's hierarchy, card against CPU;
 14. the adaptive composite: AMGSolver.setup(method="adaptive") on
     anisotropic_diffusion_2d(512, coefficient="random") (262,144 dofs,
     MEASURED.md's record) with 2 components and the CLI's defaults
     (tools.bootstrap_study.adaptive_config): the setup's phases, each
     component's levels and op complexity, K1's, K2's and K3's launches by (rows, cols, k) (K3
     at k = 63 and 64, K1 at 64), peak device memory; the peel study of
     the CLI (tools.amg.test_composite: 2 -> 1 components, PCG and stationary
     to 1e-12, at most 1000 iterations, eager): PCG with 2 components
     converges in fewer iterations than with 1 and in at most 128; 3 PCG
     solves of A x = A x_true to rtol 1e-6 and a stationary one (at most
     100 iterations), each eager and compiled, bitwise equal; the
     composite V-cycle's times; the composite checkpoint, its apply
     bitwise equal after a load; K1 + K2 and K3 against their plain
     versions at every (matrix, k) the path launched, float64 and
     float32, timed and checked as phases 3 and 8 do (K3 bitwise against
     its first design), with the library's SpMM and the bound, K3 at k =
     63 and 64 beside half its bound, and launches x (time - bound); a
     small composite
     (aniso2d(32)) on the card against the same hierarchies on the CPU
     (1e-10); rand-SVD (python -m tpu_amg_torch.tools.rand_svd_test) on
     the card, score >= 0.99;
 15. mixed-precision cycles (tpu_amg_torch.precision), on the matrices
     and hierarchies of phases 3-5, 7 and 14 (no new setup): K1 + K2 at
     (bf16, f64), (bf16, f32) and (f32, f64) on phase 3's 262,144-row
     A0 and the SA path's A0, P0, R0, A1 (k = 1, 8), K3 on the
     structured A0 and A1 and the adaptive fine A (k = 1, 8, 64), each
     against its plain version at T's tolerance, two calls bitwise
     equal, K3 (the row-chunk design at k = 1) and the band tiles bitwise
     equal to the first design and timed in turns with it, beside the
     (T, T) kernel on the widened values, the library's
     call on them and the bound of the bytes with V-sized values; the
     SA and structured paths cast to None, "f32", "bf16_values" and
     "bf16", each with 3 PCG solves to rtol 1e-6 eager and compiled
     (bitwise equal), iterations <= the uncast cycle's + 3, true
     residual <= 1e-5 ||b||, bf16 launches in the bf16 modes, the
     V-cycle's times and its dense and smoother shares; the adaptive
     composite in "bf16_values" and "f32" (one eager PCG each, the
     composite V-cycle and the block smoothers' share, both by
     tools.vcycle_breakdown; "f32" within the
     uncast count + 3, "bf16_values" reported as it ends, with a finite
     iterate: neither package's cycle converges within that bound on
     this problem, tests/test_torch_precision.py), and phase 14's small
     composite cast to both, card against CPU (1e-10); the small SA input
     card against CPU in "bf16_values" (1e-10) and "bf16" (5e-2); the
     CLI's --structured poisson3d(100) --tol 1e-6 --precision
     bf16_values (cg <= 14, K3 at (bf16, f64)); every mixed kernel
     launched; its own wall time;
 16. block-3 elasticity: unstructured_elasticity_3d(--elasticity-side)
     (40: 192,000 dofs) with elasticity_3d_config (setup3d's elasticity
     config), float64: AMGSolver.setup in a worker process (below), its
     phases, peak device memory and launches (K1 at the bootstrap's
     k = 11), the checkpoint it saved loaded here (the tools.setup3d /
     tools.solve3d workflow), each level's format, rows, entries and
     block size (3, then 6), 2 PCG solves of A x = A x_true to rtol 1e-6
     eager and compiled (bitwise equal, at most 66 iterations, twice the
     JAX package's 33 at 499,125 dofs; true residual <= 1.01 rtol), the
     V-cycle's times, and K1 + K2 against their plain versions at every
     (matrix, k) the path launched them on (float64; the rows of the
     block-6 coarse A run past K1's cap into K2), timed beside the
     library's SpMV / SpMM and the bound;
 17. the float32 bootstrap (find_near_null in float32, SolverConfig
     bootstrap_dtype): setups of the SA (phase 4's problem), elasticity
     (phase 16's) and adaptive (phase 14's) problems from the float64
     setups' own draws (solver.setup_draws): near_null seconds and each
     level's rows both ways, the (f32, f32) launches (K1, K1 + K2, K3 at
     k = 7, 11, 63), PCG to 1e-6 within twice the JAX package's count
     (SA, elasticity) and on SA within the float64 count + 2 (on
     elasticity the float32 bootstrap costs 0-5 iterations: printed, see
     BOOTSTRAP_EXTRA), the adaptive composite's PCG to 1e-12 within 1.1 x
     the float64 count, ||E||_A; the three kernels at those shapes in
     float32 against their plain versions (phases 3, 16, 14);
 18. classical AMG: poisson2d(CLASSICAL_SIDE) (320: 102,400 dofs) with
     the CLI's defaults and --smoother chebyshev, float64, the config
     built by the CLI's own parser and builders (tools.amg: parse_args,
     configs, solver_config, build_hierarchy): its setup in a worker
     process (below), its phases, each CR round's reduction and C count,
     the hierarchy's seconds by step (CR is host work in both packages);
     the checkpoint loaded here (the auto W-cycle, mu = 2), the level
     table, W-cycle PCG of A x = A x_true to rtol 1e-8 eager and
     compiled (bitwise equal, at most 30 iterations, twice the JAX
     package's 15; true residual <= 1.01 rtol), ||E||_A beside the JAX
     package's 0.696, launches by (rows, cols, k) (K1 and K3 > 0; K2
     where a row passes K1's cap), the W-cycle's times; the two-level
     multigrid of levels 0-1, whose "cholesky" coarse solve is banded
     past the dense cap (n, b, s, nb, bytes, the factor's seconds; the
     apply at k = 1 and 8 within 1e-10 of scipy's sparse LU; its device
     us against its HBM bound, both stacks read by each sweep; PCG eager and compiled bitwise equal, no
     more iterations than the W-cycle); the checkpoint saved and loaded
     (mu = 2, the W-cycle bitwise equal); K1 (and K2) and K3 (the
     fine A) against their plain versions at every (matrix, k) the path
     launched them on.
  19. distribution on torch.distributed, its parts one after
     another so that no timed solve shares the card: (a) NCCL at world
     size 1 in this process: phase 4's SA multigrid and phase 7's
     structured one sharded (parallel.dist.solve_sharded: HaloCSR K1 +
     K2, HaloDIA K3, halo 0), eager PCG of A x = A x_true to rtol 1e-6
     against the unsharded eager solve (the same iterations, x within
     1e-12, bitwise or not), each solve run once untimed and then timed,
     launches counted over the timed sharded solve; (b) both paths again
     on 2 gloo ranks sharing the card (this script's own rank program,
     python -m chip_smoke --dist-rank: the SA multigrid from phase 4's
     checkpoint, the structured one rebuilt; a halo above 0 on both fine
     levels; each level's form and halo, per-shard nnz, bytes a fine
     SpMV, seconds an iteration, launches by (rows, cols, k) summed over
     the ranks: K1 and K2 (SA) and K3 (structured) > 0; the same
     iterations as one rank, x within 1e-10); (c) tools.dryrun_multichip
     on 2 gloo ranks and at world size 1 (NCCL, here), every gate; the
     ranks start from this process's build; then K1 + K2 on rank 0's
     block of A0 and R0 at 2 ranks and K3 on its padded local structured
     A0, against their plain versions, timed beside the library's call
     and their bounds (K3's on the shard's own rows), their launches
     those of (b) at that shape.
  20. the rest of M21, each path's counts set to 0 just before it and
     read just after it: (a) tools.bench_vcycle through its entry point
     (poisson3d(64) float32 structured V-cycle, f32 / bf16_values / bf16,
     the speed-of-light estimate over stream_sum's 1 GiB read rate, the
     f32 PCG solve within 18 iterations and the bf16_values one
     converged), then K3 on its A0 and A1 at (f32, f32) against the
     plain version; (b) tools.bench_unstructured at side 512 (262,144
     dofs) on the checkpoint of its setup in a worker: its JSON line,
     bf16_values within 64 iterations, op complexity beside the JAX
     package's 1.64; (c) the real-FEM solve: tools.make_fem_fixture
     --side 512 written into a temporary directory and set up in a worker
     (260,100 dofs after the loader's Dirichlet elimination, the bench's
     config), loaded here, PCG to rtol 1e-6 on the fixture's load vector
     and on b = A x_true, both converged within 200 iterations, the true
     relative residual of b = A x_true and of a float64 outer loop around
     the float32 cycle on the load vector within 1.01 rtol, and of the
     float32 load-vector solve within 1.01 rtol plus the rounding of one
     float32 A·x (its bound), the synthetic count of (b) beside; K1 + K2
     (and K3 where a level is DIA) on its A0, P0 and R0 at (f32, f32)
     against the plain versions; (d) tools.vcycle_breakdown on phase 4's
     SA multigrid and phase 14's composite (each level's A, smoother, P, R,
     the coarse solve, the sum of components within 0.7-1.15 of the full
     apply, the composite's costliest smoother and its share); (e)
     tools.aggregation on aniso2d(256): each logged pass's metrics,
     modularity not falling from the first to the last, the JAX
     example's JSON keys; (f) tools.amg
     --viz-out on aniso2d(64): one level entry a level but the coarsest,
     each node_to_agg of its level's length;
  21. the ELL and BSR containers (sparse/ell.py, sparse/bsr.py), which
     apply through K1 + K2 on a capped CSR of their stored entries:
     phase 4's SA solver and phase 16's elasticity solver rebuilt with A
     and every sparse level of the cycle over containers (the JAX
     package's rules: a BSR for a square level of block size > 1, else
     an ELL), before phase 19; (a) K1 + K2 on the SA A0 and R0 ELLs and
     the elasticity A0 (bs 3) and A1 (bs 6) BSRs at k = 1 and 8, float64
     and float32, against the plain versions as phase 3 holds them,
     whether each capped CSR is the CSR's own, the tail's rows beside
     the CSR's, and the CSR operator's time on the same matrix; (b) each
     path's PCG of A x = A x_true over containers, eager and compiled,
     against the CSR-backed solve (the same iterations, x within 1e-12;
     bitwise printed), the counts set to 0 just before and read just
     after (every K1 and K2 launch on a container); (c) in phase 19's
     NCCL group of one rank, the SA solve over ELLs sharded (HaloELL at
     every sparse level) against phase 19's HaloCSR solve, and shard_ell
     of the ELL A0 applied bitwise as the ELL;
  22. the SpMV throughput benchmark (tools.bench, the port of bench.py),
     run right after phase 15: (a) its entry point in-process at --grid
     24 --side 128, whose last line must hold bench.py's eight keys,
     every number finite and > 0, with K1 and K3 launched and K2 not;
     (b) the counts set to 0 again just before and read just after
     bench.measure on phase 7's poisson3d(100) and phase 10's FEM 1M
     (the matrices already built), its record printed on a line of its
     own: K3 ("dia", and the DIA with bf16 values) and K1 ("csr", "ell",
     the FEM 1M at (f32, f32) and (bf16, f32)) launched, K2 not (no row
     passes K1's cap); (c) every timed apply against its plain version on
     ones and on a seeded x, timed beside the library's SpMV and their
     bound, "csr" and "ell" within 5% of each other, and K3's (bf16,
     f32) apply on the structured A0 and K1's on the FEM 1M each timed
     in turns with the call that phase 15 or 10 timed on the same
     matrix, within 10% of it; the many-column designs' tables of its
     two 1M-row CSR matrices, their host build seconds and device bytes.
  23. the design sweep: K1's staged SpMM and its first SpMM design,
     K2's pieces and its rows design, in turns, at every k of
     tools.spmmsweep.K_SWEEP (2-64, those the paths launch among them)
     on the paths' own matrices (the SA A0, R0, A1; the adaptive c1 P0,
     R0, A1, R2; the elasticity A0; the classical A1), float64 and
     float32, each held as phase 3 holds them, beside K1's routed design
     (spmv.k1_design); by dtype the sums of each design's and the routed
     times, and the cases where the router's pick was more than 3%
     slower than the other design.
At k > 1 every K1 + K2 case of phases 3, 14-18 (and phase 15's mixed
pairs) also times K1's two designs (the staged SpMM, csrc/csr_spmm.cuh,
and the first) and K2's two (the pieces and the rows design) in turns:
the staged SpMM must give the first design's bits and the routed
call's, the pieces agree with K2's rows design and the plain version to
the dtype's tolerance, two calls of each bitwise equal; there the plain
versions are timed over graphs of PLAIN_REPS calls.  Every path's K1
launches by design must be the router's on its own matrices (those
timed; spmv.k1_design by the bytes of an X row and the mean capped row
length); launches x time at k > 1 is printed by path for the routed
design, the first and the staged SpMM, and for K2's pieces and rows.
The setups of phases 16-18 (the float64 elasticity one, the three
float32-bootstrap ones and the classical one, first) run in two worker
processes started after phase 2, beside phases 3-15: host setup is
single-threaded and takes
minutes, and the whole run must stay well inside its time limit.  Each
worker sets its counts to 0 before its setup, reads them after it and
returns them; the workers are stopped when the script ends.  After the
setups the workers run phase 13's three longest CLI runs (SA aniso2d
n=256, the composite, elasticity3d), counted the same way and checked
after phase 18, and then phase 20's two 262k setups.
Then every path that runs K3 below k = 8 (structured, adaptive,
classical, bench_vcycle, the real FEM) solves one seeded b by eager PCG
twice, with K3 as routed and with those launches on the first design:
the same iterations, histories and, bitwise, x.  Then every row timed
with its bytes in the L2 cache is bound by the L2 read rate of phase 11,
and K1's and K2's launches x (time - bound) are printed for the SA and
structured paths, and at k > 1 for both designs of each on the SA,
adaptive, elasticity, classical and float32-bootstrap paths, with
launches x time; the gather figure of each k > 1 case (nnz x k x
itemsize, an X row an entry) is printed over the L2 read rate; every
K3 case below k = 8 is printed with its path's
launches, the row-chunk and first designs' times, the bound and the
launch's fixed cost, and launches x time summed for both designs.
Every count is set to 0 just before each path (4, 6, 7, 10, 11, 12, each CLI run, the adaptive
setup, its solves, each mode of phase 15, phase 18's W-cycle and
two-level runs, phase 19's sharded solves) and read just after it,
before the comparison launches.  The last two lines are a JSON object of
per-kernel results (with each kernel's bound and the library call's
time; phase 15 adds one entry a mixed kernel and pair; `dia_spmv_row`
is K3's row-chunk design, its cases below k = 8 in `shapes`) and the
device line.  With no CUDA device it exits with code 2
and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

RTOL = 1e-6
MAX_ITERS = 46  # twice the reference's 23 PCG iterations for this config
STRUCTURED_SIDE = 100  # poisson3d(100): 1,000,000 dofs
MAX_ITERS_STRUCTURED = 14  # twice the reference's 7 at poisson3d(100)
STATIONARY_MAX = 200  # the stationary solves' cap, to rtol 1e-6
CLI_SA_N = 256  # the CLI's SA default problem: aniso2d(256), 65,536 dofs
# card against CPU ||E||_A: (power steps, relative tolerance); after 100
# steps the estimate sits on the near-constant mode, whose A-norm sums
# ~15 terms of order 1 to 1e-8, so rounding (~15 eps / 1e-8) bounds it
E_NORM_CASES = ((10, 1e-10), (100, 2e-7))
# the kernels sum in another order than the plain versions
TOL = {"float64": 1e-12, "float32": 1e-5}
STREAM_MIB = 32  # the harness's TOTAL (tools/streambench.py:25)
STREAM_BIG_MIB = 1024  # past the card's 50 MB L2
FEM_SIDE = 1024  # unstructured_fem_system(1024): the harnesses' 1M matrix
PRIMITIVE_OP = "gather_fma"  # the WELL stage-B core: the kernels-line case
COPY_BEST = "depth= 2 unit=64KB"  # a best case of the copy sweep at 1 GiB
# the adaptive composite at MEASURED.md:211-231's size: aniso2d(512) with
# random coefficients, 262,144 dofs, 2 components, the CLI's defaults;
# the JAX package took 64 PCG iterations to 1e-12 there (686 with one
# component): the limit is twice that
# K1's kernels-line reading: A0 of unstructured_poisson_3d(64), 262,144
# rows, whose bytes pass the card's L2 at k = 1, whatever --side is
K1_HEADLINE_SIDE = 64
K1_HEADLINE = "A0 side 64"
ADAPTIVE_N = 512
ADAPTIVE_COMPONENTS = 2
ADAPTIVE_TOL = 1e-12
ADAPTIVE_MAXITER = 1000
ADAPTIVE_MAX_PCG = 128
ADAPTIVE_SMALL_N = 32  # the card-against-CPU composite: aniso2d(32)
ADAPTIVE_STATIONARY_MAX = 100  # ~0.993 a cycle: the solve runs to its cap
CLI_COMPOSITE_N = 128  # the CLI's composite run: aniso2d(128), 16,384 dofs
# phase 16: unstructured_elasticity_3d(40), 192,000 dofs: its setup took
# 268 s on the H100's host (PERF.md), past the ~200 s a larger side would
# need to stay under; the JAX package took 33 PCG iterations to 1e-6 at
# 499,125 dofs (MEASURED.md:44-57): the limit is twice that
ELASTICITY_SIDE = 40
MAX_ITERS_ELASTICITY = 66
JAX_ITERS = {"SA": 23, "elasticity": 33}  # the JAX package's PCG counts
# phase 17: the float32 bootstrap's PCG counts against the float64 one's
# SA: at most the float64 count + 2.  Not held on elasticity: there the
# float32 bootstrap costs 0 to 5 iterations over float64 from the same
# draws (python -m tpu_amg_torch.tools.bootstrap_study, 3 draws x 3
# right-hand sides at side 40, PERF.md) and ||E||_A is higher in every
# draw, while its loop matches the JAX package's float32 loop
# (tests/test_torch_elasticity.py): float32 arithmetic, not the port.
# Elasticity is held to twice the JAX package's count, printed beside
BOOTSTRAP_EXTRA = {"SA": 2, "elasticity": None}
ADAPTIVE_F32_RATIO = 1.1  # the adaptive composite: at most 1.1 x
# processes running phases 16-18's setups: with 2, and phase 14's setup
# in the main process, the script ran ~1,165 s of its 1,200 s limit on
# the H100 machine's 8-core host (PERF.md); phase 14's runs in a process
# of its own beside them
SETUP_WORKERS = 3
# the workers' BLAS, OpenMP and torch thread pools, set at their spawn:
# with 8 threads each beside the main process's own host setups (phases
# 4 and 13, the critical path) the script ran 1,157 s on the H100
# machine's 8-core host, 935 s with 2 (PERF.md)
WORKER_THREADS = 2
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
JOB_WAIT = 900  # seconds a phase waits for a worker's setup, at most
CHECKPOINT_PROBE_SEED = 7  # the vector a checkpoint's apply is held on
# calls in a CUDA graph of each design, timed in turns (the median of 5
# replays): at k > 1 in every K1 + K2 case, and in phase 23's sweep
DESIGN_REPS = 20
SWEEP_REPS = 10
# calls in a CUDA graph when a plain version is timed at k > 1: it is a
# reference, no yardstick of speed, and takes 0.5-6 ms a call at k = 64
PLAIN_REPS = 10
CLI_ELASTICITY_N = 20  # the CLI's elasticity3d run: 24,000 dofs
PROFILE_SIDE = 128  # tools.profile_setup's run: 16,384 dofs
# phase 18: classical AMG on poisson2d(320), 102,400 dofs, with the CLI's
# defaults and --smoother chebyshev (MEASURED.md:428-429, :462-468): the
# JAX package's auto W-cycle took 15 PCG iterations to 1e-8 there, with
# ||E||_A 0.696 and op complexity 2.50; the limit is twice that count
CLASSICAL_SIDE = 320
CLASSICAL_TOL = 1e-8
MAX_ITERS_CLASSICAL = 30
JAX_CLASSICAL = dict(iters=15, e_norm=0.696, op_complexity=2.50)
BANDED_TOL = 1e-10  # the banded apply against scipy's sparse LU solve
CLI_CLASSICAL_N = 64  # the CLI's classical run: poisson2d(64), 4,096 dofs
# phase 13's three longest CLI runs (185 s of host setup in all on the
# H100's host, PERF.md): they run in the setup workers after phases
# 16-18's setups, beside the main process (the CLI is a process of its
# own in use), and are checked after phase 18 as the others are
CLI_WORKER_CASES = (
    (f"SA aniso2d n={CLI_SA_N}", ["--problem", "aniso2d", "--n",
                                  str(CLI_SA_N)], None),
    (f"adaptive aniso2d n={CLI_COMPOSITE_N} random",
     ["--problem", "aniso2d", "--n", str(CLI_COMPOSITE_N),
      "--coefficient", "random", "--composite", "2"], None),
    (f"SA elasticity3d n={CLI_ELASTICITY_N} (block size 3)",
     ["--problem", "elasticity3d", "--n", str(CLI_ELASTICITY_N)], None),
)


T_START = time.perf_counter()


def say(msg: str) -> None:
    print(msg, flush=True)


def mark(phase: str) -> None:
    """The script's clock at the start of a phase, on a line of its own."""
    say(f"# t={time.perf_counter() - T_START:.1f} s: phase {phase}")


def check(ok: bool, msg: str) -> None:
    say(("ok    " if ok else "FAIL  ") + msg)
    if not ok:
        sys.exit(1)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


# the row-chunk kernel's template arguments in its mangled name: the
# values' type, X's type, k, R and C
ROW_KERNEL = (r"row_kernelI(d|f|13__nv_bfloat16)(d|f)Li(\d+)ELi(\d+)E"
              r"Li(\d+)E")
MANGLED_PAIR = {("d", "d"): "f64", ("f", "f"): "f32", ("f", "d"): "f32f64",
                ("13__nv_bfloat16", "f"): "bf16f32",
                ("13__nv_bfloat16", "d"): "bf16f64"}


def row_kernel_registers(report: dict) -> dict:
    """ptxas's report (``_build.ptxas_report``) of K3's row-chunk
    kernels by pair: {pair: [(k, R, C, registers, stack, spill
    bytes)]}."""
    import re

    out = collections.defaultdict(list)
    for name, r in report.items():
        m = re.search(ROW_KERNEL, name)
        if m:
            out[MANGLED_PAIR[m.group(1), m.group(2)]].append(
                (*(int(m.group(i)) for i in (3, 4, 5)), r["registers"],
                 r.get("stack", 0),
                 r.get("spill_stores", 0) + r.get("spill_loads", 0)))
    return {pair: sorted(rows) for pair, rows in out.items()}


def say_row_registers(report: dict) -> bool:
    """Print the row-chunk kernels' registers and spills, a line a pair;
    True where every pair has its instances (each k and (R, C) of
    ``ops.dia.row_shapes``) and none spills."""
    from tpu_amg_torch.ops import dia as dia_ops

    want = sorted((k, r, c) for k in range(1, dia_ops.ROW_MAX_K + 1)
                  for r, c in dia_ops.row_shapes(k))
    rows = row_kernel_registers(report)
    for pair, insts in sorted(rows.items()):
        say(f"ptxas -v, K3 row_kernel {pair}: " + ", ".join(
            f"k={k} R={r} C={c} {regs} regs"
            + (f" stack {st} B" if st else "") + (f" SPILL {sp} B" if sp else "")
            for k, r, c, regs, st, sp in insts))
    return (sorted(rows) == sorted(MANGLED_PAIR.values())
            and all([(k, r, c) for k, r, c, *_ in v] == want
                    and not any(sp for *_, sp in v) for v in rows.values()))


def heavy_row_matrix(seed: int = 0):
    """Random rectangular CSR with rows of 1-120 entries and duplicates
    summed: with cap 16 most rows spill to the tail."""
    from tpu_amg_torch.sparse.csr import CSR

    rng = np.random.default_rng(seed)
    n, m = 20000, 15000
    deg = rng.integers(1, 121, n)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, m, len(rows))
    return CSR.from_coo(rows, cols, rng.standard_normal(len(rows)), (n, m))


def torch_csr(indptr, indices, data, shape):
    """A torch sparse CSR tensor on the card (int32 indices): ``@ x`` is
    the library's SpMV (cuSPARSE), the yardstick beside a kernel; the
    port never calls it."""
    import torch

    return torch.sparse_csr_tensor(indptr.to(torch.int32),
                                   indices.to(torch.int32), data, shape)


def tail_csr(mat):
    """K2's tail of a CappedCSR as its own torch CSR tensor."""
    import torch

    counts = torch.zeros(mat.shape[0], dtype=torch.int64, device=mat.device)
    counts[mat.tail_row_ids.long()] = (mat.tail_ptr[1:]
                                       - mat.tail_ptr[:-1]).long()
    indptr = torch.zeros(mat.shape[0] + 1, dtype=torch.int64,
                         device=mat.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return torch_csr(indptr, mat.tail_cols, mat.tail_vals, mat.shape)


def k2_bytes(mat, k: int):
    """K2 at k columns, each input once: the tail's columns and values,
    its row table (row ids and starts), the X rows it reads, and the Y
    rows it reads and writes.  Also the first design's (a row id per
    entry, no table), for the record."""
    import torch

    isz = mat.data.element_size()
    cols = int(torch.unique(mat.tail_cols).numel())
    rows = mat.n_tail_rows
    xy = (cols + 2 * rows) * k * isz
    return (mat.n_tail * (4 + isz) + 4 * (2 * rows + 1) + xy,
            mat.n_tail * (8 + isz) + xy)


def tail_shape(mat) -> str:
    """The tail's rows, their mean and longest length, as printed."""
    lens = mat.tail_ptr[1:] - mat.tail_ptr[:-1]
    return (f"{mat.n_tail_rows} tail rows, mean "
            f"{mat.n_tail / max(mat.n_tail_rows, 1):.1f}, longest "
            f"{int(lens.max()) if mat.n_tail_rows else 0}")


def k2_lanes_sweep(mat, x, k, reps) -> dict:
    """K2's time at every team width it takes at k columns (lanes a tail
    row), through the uncounted launcher, on a zeroed Y."""
    import torch

    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.utils.timing import median_ms

    yz = torch.zeros((mat.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                     device=x.device)
    first = min(32, 1 << (k - 1).bit_length())  # the group width
    return {lanes: median_ms(
        lambda lanes=lanes: spmv.launch_coo_patch(mat, x, yz, k, lanes),
        reps, graph=True) for lanes in (8, 16, 32) if lanes >= first}


def design_case(mat, x, routed, reps, tol) -> tuple:
    """At k > 1, K1's and K2's two designs on one matrix: the staged SpMM
    (in the mode the bytes of an X row give) and the first design
    (``launch_first_spmm``) timed in turns, bitwise equal to each other,
    to the routed call ``routed`` and across two calls, beside the
    router's pick (``spmv.k1_design``); K2's pieces and the rows design
    (a team of lanes a row) in turns on a random Y, the pieces within
    ``tol`` of it and of the plain version, two calls bitwise.  Returns
    (ok, text, fields)."""
    import torch

    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.utils.timing import alternating_ms

    k = x.shape[1]
    first = spmv.launch_first_spmm(mat, x)
    staged = spmv.launch_staged_spmm(mat, x)
    again = spmv.launch_staged_spmm(mat, x)
    torch.cuda.synchronize()
    same1 = (torch.equal(first, staged) and torch.equal(staged, again)
             and torch.equal(routed, staged))
    isz = x.element_size()
    out = dict(k1_gather_bytes=mat.data.numel() * k * isz,
               k1_design=spmv.k1_design(k, isz, mat.row_mean),
               k2_gather_bytes=None, k2_rows_ms=None, k2_pieces_ms=None)
    out["k1_first_ms"], out["k1_staged_ms"] = alternating_ms(
        [lambda: spmv.launch_first_spmm(mat, x),
         lambda: spmv.launch_staged_spmm(mat, x)], reps)
    out["k1_routed_ms"] = out["k1_first_ms" if out["k1_design"] == "first"
                              else "k1_staged_ms"]
    text = (f"; K1 staged {out['k1_staged_ms'] * 1e3:.2f} us ("
            + ("X staged" if k * isz <= spmv.SPMM_STAGE_ROW
               else "gather mode")
            + f"), first {out['k1_first_ms'] * 1e3:.2f} us (in turns; "
            f"bitwise equal, and to the routed call: {same1}); routed "
            f"{out['k1_design']} (rows {mat.row_mean:.1f} entries on "
            f"average)")
    ok = same1
    if mat.n_tail:
        g = torch.Generator(device="cuda").manual_seed(k + 1)
        y0 = torch.randn((mat.shape[0], k), generator=g, device="cuda",
                         dtype=x.dtype)
        rows, pieces, twice, ref = (y0.clone() for _ in range(4))
        lanes = spmv.k2_lanes(mat.n_tail_rows, k,
                              spmv.sm_count(x.device.index))
        spmv.launch_coo_patch(mat, x, rows, k, lanes)
        spmv.launch_coo_pieces(mat, x, pieces, k)
        spmv.launch_coo_pieces(mat, x, twice, k)
        spmv.plain_coo_patch(mat, x, ref)
        torch.cuda.synchronize()
        scale = max(float(ref.abs().max()), 1e-300)
        err_rows = float((pieces - rows).abs().max()) / scale
        err_plain = float((pieces - ref).abs().max()) / scale
        same2 = torch.equal(pieces, twice)
        yz = torch.zeros_like(y0)
        out["k2_rows_ms"], out["k2_pieces_ms"] = alternating_ms(
            [lambda: spmv.launch_coo_patch(mat, x, yz, k, lanes),
             lambda: spmv.launch_coo_pieces(mat, x, yz, k)], reps)
        out["k2_gather_bytes"] = mat.n_tail * k * x.element_size()
        ok = ok and same2 and max(err_rows, err_plain) <= tol
        text += (f"; K2 pieces {out['k2_pieces_ms'] * 1e3:.2f} us, rows "
                 f"{out['k2_rows_ms'] * 1e3:.2f} us (in turns; rel err "
                 f"against rows {err_rows:.2e}, plain {err_plain:.2e}, "
                 f"limit {tol:.0e}; two calls bitwise equal: {same2})")
    return ok, text, out


def kernel_cases(name, mat_by_dtype, reps, results, ks=(1, 8)):
    """Compare K1, K2 and K1+K2 with the plain versions on one matrix;
    time each on the device (CUDA graph replays) beside the library's
    SpMV / SpMM on the capped part and on the tail, and the bounds; at
    k=1 also K1's first design (the ablation's `rowgroup`)."""
    import torch

    from tpu_amg_torch.ops import spmv, spmv_stages
    from tpu_amg_torch.utils.timing import hbm_bound_ms, median_ms

    for dtype, mat in mat_by_dtype.items():
        dname = str(dtype).replace("torch.", "")
        lib1 = torch_csr(mat.indptr, mat.indices, mat.data, mat.shape)
        lib2 = tail_csr(mat) if mat.n_tail else None
        for k in ks:
            g = torch.Generator(device="cuda").manual_seed(k)
            shape = (mat.shape[1],) if k == 1 else (mat.shape[1], k)
            x = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            y1 = spmv.csr_spmv_capped(mat, x)
            p1 = spmv.plain_csr_spmv_capped(mat, x)
            y2 = torch.zeros_like(y1)
            p2 = torch.zeros_like(y1)
            again = torch.zeros_like(y1)
            spmv.coo_patch(mat, x, y2)
            spmv.coo_patch(mat, x, again)
            spmv.plain_coo_patch(mat, x, p2)
            y = y1 + y2
            p = p1 + p2
            torch.cuda.synchronize()
            same = torch.equal(y2, again)
            scale = float(p.abs().max())
            rel = float((y - p).abs().max()) / max(scale, 1e-300)
            err1 = float((y1 - p1).abs().max())
            err2 = float((y2 - p2).abs().max())
            t1 = median_ms(lambda: spmv.csr_spmv_capped(mat, x), reps,
                           graph=True)
            plain_reps = reps if k == 1 else min(reps, PLAIN_REPS)
            t1p = median_ms(lambda: spmv.plain_csr_spmv_capped(mat, x),
                            plain_reps, graph=True)
            t2 = t2p = float("nan")  # K2 launches only for a tail
            if mat.n_tail:
                yz = torch.zeros_like(y1)
                t2 = median_ms(lambda: spmv.coo_patch(mat, x, yz), reps,
                               graph=True)
                t2p = median_ms(lambda: spmv.plain_coo_patch(mat, x, yz),
                                plain_reps, graph=True)
            lib = dict(k1_lib_ms=median_ms(lambda: lib1 @ x, reps, graph=True),
                       k1_bound_ms=hbm_bound_ms(spmv.k1_bytes(mat, k)),
                       k1_bytes=spmv.k1_bytes(mat, k), k2_bytes=None,
                       k2_lib_ms=None, k2_bound_ms=None,
                       k2_old_bound_ms=None, rowgroup_ms=None,
                       k2_by_lanes=None, k2_lanes=None)
            if k == 1:
                lib["rowgroup_ms"] = median_ms(
                    lambda: spmv_stages.csr_spmv_stages(mat, x, "rowgroup"),
                    reps, graph=True)
                designs_ok, designs_text = True, ""
            else:
                designs_ok, designs_text, more = design_case(
                    mat, x, y1, min(reps, DESIGN_REPS), TOL[dname])
                lib.update(more)
            if lib2 is not None:
                lib["k2_lib_ms"] = median_ms(lambda: lib2 @ x, reps,
                                             graph=True)
                new, old = k2_bytes(mat, k)
                lib["k2_bound_ms"] = hbm_bound_ms(new)
                lib["k2_bytes"] = new
                lib["k2_old_bound_ms"] = hbm_bound_ms(old)
                if dtype == torch.float64 and k in (1, 8):
                    lib["k2_by_lanes"] = k2_lanes_sweep(mat, x, k, reps)
                    lib["k2_lanes"] = spmv.k2_lanes(
                        mat.n_tail_rows, k, spmv.sm_count(x.device.index))
            check(
                rel <= TOL[dname] and same and designs_ok,
                f"kernels {name} {dname} k={k}: shape {mat.shape} "
                f"nnz {mat.nnz} tail {mat.n_tail} row blocks "
                f"{mat.n_blocks}: max rel err {rel:.3e} (limit "
                f"{TOL[dname]:.0e}); K1 {t1:.4f} ms plain {t1p:.4f} ms "
                f"library {lib['k1_lib_ms']:.4f} ms bound "
                f"{lib['k1_bound_ms']:.4f} ms"
                + ("" if k != 1 else
                   f" (K1's first design {lib['rowgroup_ms']:.4f} ms)")
                + f"; K2 {t2:.4f} ms plain {t2p:.4f} ms"
                + ("" if lib2 is None else
                   f" library {lib['k2_lib_ms']:.4f} ms bound "
                   f"{lib['k2_bound_ms']:.4f} ms (first design's "
                   f"{lib['k2_old_bound_ms']:.4f}; {tail_shape(mat)}"
                   + ("" if lib["k2_by_lanes"] is None else
                      f"; by lanes a row ({lib['k2_lanes']} in use): "
                      + ", ".join(
                          f"{n} {t * 1e3:.2f} us"
                          for n, t in lib["k2_by_lanes"].items()))
                   + f"); two K2 calls bitwise equal: {same}")
                + designs_text,
            )
            results.append(dict(case=name, dtype=dname, k=k,
                                shape=tuple(mat.shape), err1=err1,
                                err2=err2, k1_ms=t1, k1_plain_ms=t1p,
                                k2_ms=t2, k2_plain_ms=t2p,
                                n_tail=mat.n_tail, **lib))


def say_excess(kernel, key, path, by_shape, results, cases):
    """Print a kernel's launches x (time - bound) on a path, for each
    (rows, cols, k) it ran there, from the float64 times of ``cases``."""
    excess, total = [], 0.0
    for shape, count in sorted(by_shape.items()):
        case = next((c for c in results if c["dtype"] == "float64"
                     and (*c["shape"], c["k"]) == shape
                     and c["case"] in cases), None)
        if case is None:
            excess.append(f"{shape}: {count} launches, not timed")
            continue
        ms = count * (case[f"{key}_ms"] - case[f"{key}_bound_ms"])
        total += ms
        excess.append(f"{case['case']} k={shape[2]} {shape}: {count} x "
                      f"({case[f'{key}_ms'] * 1e3:.2f} - "
                      f"{case[f'{key}_bound_ms'] * 1e3:.2f} us) = {ms:.3f} ms")
    say(f"{kernel} on {path}, launches x (time - bound), float64: "
        f"{total:.3f} ms in all; " + "; ".join(excess))


def say_design_excess(path, k1_by_shape, k2_by_shape, results,
                      dtype="float64", cases=None, k1_designs=None) -> dict:
    """At k > 1 on a path: launches x (time - bound) and launches x time
    of K1's routed design, its first design and its staged SpMM, and of
    K2's pieces (routed at every k > 1) and rows design, from the
    ``dtype`` cases timed in this run (of ``cases`` where given) at each
    (rows, cols, k) the path launched; the sums, by kernel.  With
    ``k1_designs`` (the path's K1 launches counted by design), checks
    them against the router's pick on each timed case (the launches of
    untimed shapes may go to any design)."""
    out = {}
    want, untimed = collections.Counter(), 0
    for kernel, by_shape, designs in (
            ("K1", k1_by_shape, ("k1_routed_ms", "k1_first_ms",
                                 "k1_staged_ms")),
            ("K2", k2_by_shape, ("k2_pieces_ms", "k2_rows_ms"))):
        bound = f"{kernel.lower()}_bound_ms"
        tot = dict(launches=0, ms={d: 0.0 for d in designs},
                   excess_ms={d: 0.0 for d in designs})
        parts = []
        for shape, n in sorted(by_shape.items()):
            if shape[2] == 1:
                want["spmv"] += n if kernel == "K1" else 0
                continue
            c = next((c for c in results if c["dtype"] == dtype
                      and (*c["shape"], c["k"]) == tuple(shape)
                      and c.get(designs[0]) is not None
                      and (cases is None or c["case"] in cases)), None)
            if c is None:
                parts.append(f"{shape}: {n} launches, not timed")
                untimed += n if kernel == "K1" else 0
                continue
            tot["launches"] += n
            for d in designs:
                tot["ms"][d] += n * c[d]
                tot["excess_ms"][d] += n * (c[d] - c[bound])
            if kernel == "K1":
                want[c["k1_design"]] += n
            parts.append(f"{c['case']} k={shape[2]} {shape}: {n} x ("
                         + " / ".join(f"{c[d] * 1e3:.2f}" for d in designs)
                         + f" - {c[bound] * 1e3:.2f} us)"
                         + (f" routed {c['k1_design']}" if kernel == "K1"
                            else ""))
        out[kernel] = tot
        names = " / ".join(d.split("_")[1] for d in designs)
        if tot["launches"] or parts:
            say(f"{kernel} at k > 1 on {path}, {dtype}, {names}: launches x "
                f"(time - bound) " + " / ".join(
                    f"{tot['excess_ms'][d]:.3f}" for d in designs)
                + " ms, launches x time " + " / ".join(
                    f"{tot['ms'][d]:.3f}" for d in designs)
                + f" ms over {tot['launches']} launches; " + "; ".join(parts))
    if k1_designs is not None:
        got = +collections.Counter(k1_designs)
        ok = (got["spmv"] == want["spmv"]
              and sum(got.values()) == sum(want.values()) + untimed
              and all(want[d] <= got[d] <= want[d] + untimed
                      for d in ("first", "staged", "gather")))
        check(ok, f"{path}: K1 launches by design {dict(sorted(got.items()))}"
                  f", the router's on the timed matrices "
                  f"{dict(sorted((+want).items()))} ({untimed} launches of "
                  f"untimed shapes)")
    return out


def spmm_sweep_phase(mats: dict, reps: int) -> dict:
    """The design sweep: K1's staged and first designs and K2's pieces
    and rows designs, in turns, at every k of tools.spmmsweep.K_SWEEP on
    the paths' own matrices (``mats``: name -> float64 CappedCSR), in
    float64 and float32 (the values cast, the tables shared), each
    checked as tools.spmmsweep checks it, beside K1's routed design; by
    dtype the sums of each design's and the routed times."""
    import torch

    from tpu_amg_torch.tools import spmmsweep

    t0 = time.perf_counter()
    records = []
    for dtype in (torch.float64, torch.float32):
        records += spmmsweep.sweep(
            {name: m if dtype == torch.float64 else m.astype(dtype)
             for name, m in mats.items()}, reps=reps, say=say)
    bad = [f"{r['matrix']} {r['dtype']} k={r['k']}" for r in records
           if not r["ok"]]
    sums = {dname: spmmsweep.summary([r for r in records
                                      if r["dtype"] == dname])
            for dname in ("float64", "float32")}
    check(not bad,
          f"design sweep over {len(mats)} matrices x "
          f"{len(spmmsweep.K_SWEEP)} k x 2 dtypes: the staged SpMM bitwise "
          f"the first design's, the pieces within tolerance of the rows "
          f"design's and of plain, two calls bitwise, in every case "
          f"({len(bad)} not: {bad}); "
          + "; ".join(spmmsweep.say_summary(d, v) for d, v in sums.items())
          + f"; {time.perf_counter() - t0:.1f} s")
    return dict(records=records, sums=sums)


def bound_in_l2(results, dia_results, stream_recs, l2) -> None:
    """Re-bound every timed row whose bytes fit in the card's L2 by the
    L2 read rate ``l2`` (measured by the copy probes in this run, without
    a call's fixed cost), printing each with the data sheet's HBM time it
    replaces, which is no floor in L2."""
    import torch

    from tpu_amg_torch.tools import dmabench

    dev = torch.device("cuda")
    lines = []

    def rebound(rec, nbytes_key, bound_key, label):
        nbytes = rec.get(nbytes_key)
        if nbytes is None or not dmabench.in_l2(nbytes, dev):
            return
        b = dmabench.bound(nbytes, dev, l2)
        lines.append(f"{label} {b['bound_ms'] * 1e3:.2f} us (HBM "
                     f"{b['hbm_bound_ms'] * 1e3:.2f})")
        rec[bound_key] = b["bound_ms"]

    gathers = []
    for c in results:
        tag = f"{c['case']} {c['dtype']} k={c['k']}"
        rebound(c, "k1_bytes", "k1_bound_ms", f"K1 {tag}")
        rebound(c, "k2_bytes", "k2_bound_ms", f"K2 {tag}")
        # the X rows the first designs gather, an entry each, at L2's rate
        for key in ("k1", "k2"):
            if c.get(f"{key}_gather_bytes"):
                c[f"{key}_gather_ms"] = (c[f"{key}_gather_bytes"]
                                         / l2["gbps"] / 1e6)
                gathers.append(f"{key.upper()} {tag} "
                               f"{c[f'{key}_gather_ms'] * 1e3:.2f} us")
    for c in dia_results:
        rebound(c, "bytes", "bound_ms",
                f"K3 {c['case']} {c['dtype']} k={c['k']}")
    for r in stream_recs:
        rebound(r, "bytes", "bound_ms", f"stream_sum {r['name']}")
    say(f"bounds in L2, over {l2['gbps']:.1f} GB/s ({l2['origin']}): "
        + "; ".join(lines))
    say(f"at k > 1, the gather figure (nnz x k x itemsize: an X row an "
        f"entry) over {l2['gbps']:.1f} GB/s: " + "; ".join(gathers))


def constant_mode_factor(op, pc) -> float:
    """||E 1||_A / ||1||_A for E = I - M A: how far one V-cycle of the
    stationary iteration damps the constant vector."""
    import torch

    one = torch.ones(op.shape[0], dtype=torch.float64, device=op.mat.device)

    def a_norm(v):
        return float(torch.sqrt(torch.dot(v, op.mv(v))))

    return a_norm(one - pc.mv(op.mv(one))) / a_norm(one)


def eager_and_compiled(solver, b, method: str, rtol: float, maxiter: int):
    """One solve of ``b`` by the method's eager solve and one through
    ``solver.solve`` (``AMGSolver.compile``: a CUDA graph of one
    iteration, replayed): [(x, info, seconds)] for each, in that order."""
    import torch

    from tpu_amg_torch.solvers import cg, stationary_iteration

    eager = cg if method == "cg" else stationary_iteration
    out = []
    for solve in (lambda: eager(solver.op, b, solver.preconditioner,
                                 rtol=rtol, maxiter=maxiter),
                  lambda: solver.solve(b, rtol=rtol, maxiter=maxiter,
                                       method=method)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = solve()
        torch.cuda.synchronize()
        out.append((x, info, time.perf_counter() - t0))
    return out


def check_same_solve(label: str, pair, first: bool) -> None:
    """The compiled solve gives the eager one's iterations, history and,
    bitwise, x; prints the seconds of each (the first compiled solve of
    a key includes its capture)."""
    import torch

    (xe, ie, te), (xg, ig, tg) = pair
    same_hist = ie.history().tolist() == ig.history().tolist()
    same_x = torch.equal(xe, xg)
    check(ie.iters == ig.iters and same_hist and same_x,
          f"{label}: compiled (CUDA graph) {ig.iters} / eager {ie.iters} "
          f"iterations, histories equal: {same_hist}, x bitwise equal: "
          f"{same_x}; eager {te:.4f} s ({te / max(ie.iters, 1) * 1e3:.3f} "
          f"ms an iteration), compiled {tg:.4f} s "
          f"({tg / max(ig.iters, 1) * 1e3:.3f} ms an iteration"
          + ("; its capture included)" if first else ")"))


def first_design_solves(paths) -> None:
    """Each path's eager PCG solve as K3 routes it, then again with
    every K3 launch below TILED_MIN_K sent to the first design (the
    wrapper's row-chunk launch swapped for the first design's for that
    solve): the same iterations, residual history and, bitwise, x.
    ``paths``: (label, operator, preconditioner, rtol, maxiter); b is
    seeded, in the operator's dtype.  Run after every path's launch
    counts were read: these solves count launches too."""
    import torch

    from tpu_amg_torch.ops import dia as dia_ops
    from tpu_amg_torch.solvers import cg

    for label, op, pc, rtol, maxiter in paths:
        b = torch.from_numpy(np.random.default_rng(16).standard_normal(
            op.shape[0])).to("cuda", op.mat.dtype)
        x1, i1 = cg(op, b, pc, rtol=rtol, maxiter=maxiter)
        routed = dia_ops._row
        dia_ops._row = dia_ops._first
        try:
            x2, i2 = cg(op, b, pc, rtol=rtol, maxiter=maxiter)
            torch.cuda.synchronize()
        finally:
            dia_ops._row = routed
        same_hist = i1.history().tolist() == i2.history().tolist()
        same_x = torch.equal(x1, x2)
        check(i1.iters == i2.iters and same_hist and same_x,
              f"{label}: eager PCG with K3 below k = "
              f"{dia_ops.TILED_MIN_K} on the row-chunk design {i1.iters} / "
              f"on the first design {i2.iters} iterations (rtol "
              f"{rtol:.0e}), histories equal: {same_hist}, x bitwise "
              f"equal: {same_x}")


def run_cli(module: str, argv) -> tuple:
    """``python -m <module> <argv>`` in this process (so that the launch
    counts see it), its standard output kept: (the final line, the
    seconds, the whole standard output)."""
    import contextlib
    import io
    import runpy

    out = io.StringIO()
    saved = sys.argv
    sys.argv = [module, *argv]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_module(module, run_name="__main__")
    except SystemExit as exc:  # sys.exit(main()) of a tool that returned 0
        if exc.code not in (0, None):
            raise
    finally:
        sys.argv = saved
    lines = out.getvalue().strip().splitlines()
    return ((lines[-1] if lines else ""), time.perf_counter() - t0,
            out.getvalue())


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from tpu_amg_torch.ops import dia, dma, primitives, spmv, spmv_stages, stream

    for module in (spmv, dia, stream, spmv_stages, dma, primitives):
        module.reset_launch_counts()


def stream_cases(bench_records, reps):
    """Every case of the probe against its plain version on the inputs
    the entry point timed (seed 0, 32 MiB per call), with the kernel's
    time from the entry point's run, and two calls bitwise equal; the
    single-input float32 cases again past L2, checked the same way and
    timed beside torch.sum and their bound, and the copy probe's best
    configuration on as many bytes.  Returns (the records at 32 MiB, the
    best float32 one, the records past L2, the best of those)."""
    import torch

    from tpu_amg_torch.ops import stream
    from tpu_amg_torch.tools import dmabench, streambench
    from tpu_amg_torch.utils.timing import hbm_bound_ms, median_ms

    dev = torch.device("cuda")
    records = []
    for bench in bench_records:
        case = next(c for c in streambench.CASES if c.name == bench["name"])
        g = torch.Generator(device=dev).manual_seed(0)
        inputs = streambench.make_inputs(case, STREAM_MIB << 20, dev, g)
        carry = torch.full((8, 128), 1.0, device=dev)
        y = stream.stream_sum(inputs, carry)
        again = stream.stream_sum(inputs, carry)
        p = stream.plain_stream_sum(inputs, carry)
        torch.cuda.synchronize()
        err = float((y - p).abs().max())
        same = torch.equal(y, again)
        t = bench["ms"]
        tp = median_ms(lambda: stream.plain_stream_sum(inputs, carry), reps,
                       graph=True)
        nbytes = bench["bytes"]
        # the library call is torch.sum over the same view: the plain
        # version; the bound counts the reads and the (tiles, 8, 128) sums
        rec = dict(name=case.name, dtype=str(case.dtype), err=err, ms=t,
                   plain_ms=tp, gbps=bench["gbps"],
                   plain_gbps=nbytes / tp / 1e6,
                   bytes=nbytes + bench["tiles"] * 4096,
                   bound_ms=hbm_bound_ms(nbytes + bench["tiles"] * 4096))
        records.append(rec)
        check(err == 0.0 and same,
              f"stream {case.name}: {nbytes} B per call, max abs err "
              f"{err:.1e} (limit 0: integer inputs), two calls bitwise "
              f"equal: {same}; kernel {t * 1e3:.2f} us "
              f"{rec['gbps']:.1f} GB/s, plain (torch.sum, the library "
              f"call) {tp * 1e3:.2f} us {rec['plain_gbps']:.1f} GB/s "
              f"({'at or under' if t <= tp else 'over'} it); bytes over "
              f"the HBM rate {rec['bound_ms'] * 1e3:.1f} us (held in L2: "
              f"not a floor)")
        del inputs
    best = max((r for r in records if r["dtype"] == "torch.float32"),
               key=lambda r: r["gbps"])
    # every single-input float32 case past L2, beside torch.sum
    bigs = []
    for case in streambench.CASES:
        if case.dtype != torch.float32 or case.n_in != 1:
            continue
        g = torch.Generator(device=dev).manual_seed(0)
        inputs = streambench.make_inputs(case, STREAM_BIG_MIB << 20, dev, g)
        carry = torch.zeros(8, 128, device=dev)
        tiles = case.tiles(STREAM_BIG_MIB << 20)
        nbytes = tiles * case.tile_bytes
        y = stream.stream_sum(inputs, carry)
        again = stream.stream_sum(inputs, carry)
        p = stream.plain_stream_sum(inputs, carry)
        torch.cuda.synchronize()
        err = float((y - p).abs().max())
        same = torch.equal(y, again)
        del y, again, p
        t = median_ms(lambda: stream.stream_sum(inputs, carry), 20,
                      graph=True)
        tp = median_ms(lambda: stream.plain_stream_sum(inputs, carry), 20,
                       graph=True)
        del inputs
        # past L2 the bytes over the HBM rate are a floor
        bigs.append(dict(name=case.name, err=err, ms=t, plain_ms=tp,
                         gbps=nbytes / t / 1e6, plain_gbps=nbytes / tp / 1e6,
                         bound_ms=hbm_bound_ms(nbytes + tiles * 4096)))
        check(err == 0.0 and same,
              f"stream {case.name} at {STREAM_BIG_MIB} MiB: max abs err "
              f"{err:.1e} (limit 0), two calls bitwise equal: {same}; "
              f"kernel {t * 1e3:.1f} us {bigs[-1]['gbps']:.1f} GB/s, "
              f"torch.sum {tp * 1e3:.1f} us {bigs[-1]['plain_gbps']:.1f} "
              f"GB/s, bound {bigs[-1]['bound_ms'] * 1e3:.1f} us")
    big = max(bigs, key=lambda r: r["gbps"])
    # the copy probe's best configuration, both engines, on as many bytes
    copy = dmabench.run(["--total-mib", str(STREAM_BIG_MIB), "--reps", "10",
                         COPY_BEST])
    big["copy_gbps"] = max(r["gbps"] for r in copy)
    return records, best, bigs, big


def ablation_phase(sa_mats, reps):
    """Phase 10: K1's stage ablation through its entry point on the FEM
    1M matrix in float32, then on the SA path's matrices ``sa_mats``
    (label -> float64 CappedCSR); every mode against its plain version,
    both timed; ``full`` bitwise against K1, and timed beside K1 and the
    library's SpMV.  Returns the kernels-line entry and {"mat": the FEM
    1M's float32 CappedCSR, "x": the x it was timed on, "k1_ms": K1's time
    on it}."""
    import torch

    from tpu_amg_torch.ops import spmv, spmv_stages
    from tpu_amg_torch.tools import wellablate
    from tpu_amg_torch.utils.timing import median_ms

    torch.cuda.synchronize()
    reset_counts()
    recs, fem, x32 = wellablate.run(["--side", str(FEM_SIDE), "--dtype", "f32",
                                     "--reps", str(reps)])
    cases = [("fem1024", fem, x32)]
    for label, mat in sa_mats.items():
        x = wellablate.make_x(mat.shape[1], "cuda", torch.float64)
        recs += wellablate.time_modes(mat, x, spmv_stages.MODES, reps, label)
        cases.append((label, mat, x))
    torch.cuda.synchronize()
    launches = spmv_stages.stages_launches
    check(launches > 0, f"launches over the ablation: csr_spmv_stages "
          f"{launches}")
    errs = []
    full = {}
    for label, mat, x in cases:
        dname = str(x.dtype).replace("torch.", "")
        # errors relative to the sums of |terms|: the FEM rows sum to
        # 1e-8, so nogather's x[r]·Σ v_j is all cancellation
        mat_abs = dataclasses.replace(mat, data=mat.data.abs())
        for mode in spmv_stages.MODES:
            y = spmv_stages.csr_spmv_stages(mat, x, mode)
            p = spmv_stages.plain_csr_spmv_stages(mat, x, mode)
            scale = float(spmv_stages.plain_csr_spmv_stages(
                mat_abs, x.abs(), mode).max())
            torch.cuda.synchronize()
            err = float((y - p).abs().max())
            errs.append(err)
            rec = next(r for r in recs if r["matrix"] == label
                       and r["mode"] == mode)
            rec["plain_ms"] = median_ms(
                lambda: spmv_stages.plain_csr_spmv_stages(mat, x, mode), reps,
                graph=True)
            check(err / scale <= TOL[dname],
                  f"ablation {label} {dname} {mode}: max abs err {err:.3e}, "
                  f"{err / scale:.3e} of the largest sum of |terms| (limit "
                  f"{TOL[dname]:.0e}); kernel {rec['ms'] * 1e3:.2f} us, plain "
                  f"{rec['plain_ms'] * 1e3:.2f} us, bound "
                  f"{rec['bound_ms'] * 1e3:.2f} us")
        y = spmv_stages.csr_spmv_stages(mat, x, "full")
        k1 = spmv.csr_spmv_capped(mat, x)
        check(torch.equal(y, k1), f"ablation {label} {dname}: full is "
              f"bitwise equal to csr_spmv_capped")
        rec = next(r for r in recs if r["matrix"] == label
                   and r["mode"] == "full")
        old = next(r for r in recs if r["matrix"] == label
                   and r["mode"] == "rowgroup")
        lib = torch_csr(mat.indptr, mat.indices, mat.data, mat.shape)
        rec["lib_ms"] = median_ms(lambda: lib @ x, reps, graph=True)
        rec["k1_ms"] = median_ms(lambda: spmv.csr_spmv_capped(mat, x), reps,
                                 graph=True)
        say(f"ablation {label} {dname}: full (K1, row blocks) "
            f"{rec['ms'] * 1e3:.2f} us (K1 itself {rec['k1_ms'] * 1e3:.2f} "
            f"us), rowgroup (K1's first design) {old['ms'] * 1e3:.2f} us, "
            f"library CSR @ x {rec['lib_ms'] * 1e3:.2f} us, bound "
            f"{rec['bound_ms'] * 1e3:.2f} us, plain "
            f"{rec['plain_ms'] * 1e3:.2f} us; full is "
            f"{'faster' if rec['ms'] < old['ms'] else 'not faster'} than "
            f"rowgroup, {'at or under' if rec['ms'] <= rec['lib_ms'] else 'over'}"
            f" the library")
        full[label] = rec
    say("ablation attribution (us; MB the mode must move): " + "; ".join(
        f"{r['matrix']} {r['mode']} {r['ms'] * 1e3:.2f} "
        f"({r['bytes'] / 1e6:.1f})" for r in recs))
    rec = full["fem1024"]
    fem_k1 = dict(mat=fem, x=x32, k1_ms=rec["k1_ms"])
    return dict(name="csr_spmv_stages", route="cuda",
                source="tpu_amg_torch/csrc/spmv_stages.cu",
                replaces="tools/well2proto.py:258, tools/well2proto.py:324, "
                         "tools/well2proto.py:409, tools/wellablate.py:44, "
                         "tools/wellablate2.py:34",
                launches=launches, max_abs_err=max(errs), ms=rec["ms"],
                plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                bound_by="bytes", library_ms=rec["lib_ms"]), fem_k1


def dma_phase(reps):
    """Phase 11: the copy probes through their entry points; every case
    against its plain version, twice; the sweep again at 1 GiB; D2's and
    D4's bounds over the L2 read rate, and the probe's fixed cost.
    Returns the kernels-line entry."""
    import torch

    from tpu_amg_torch.ops import dma
    from tpu_amg_torch.tools import dmabench, dmabench2
    from tpu_amg_torch.utils.timing import HBM_DATASHEET_GBPS, median_ms

    torch.cuda.synchronize()
    reset_counts()
    recs = dmabench.run(["--reps", str(reps)])
    l2 = recs[0]["l2"]
    recs2, _, fixed = dmabench2.run(["--reps", str(reps)], l2=l2)
    big = dmabench.run(["--total-mib", str(STREAM_BIG_MIB), "--reps", "10"])
    torch.cuda.synchronize()
    launches = dma.dma_probe_launches
    check(launches > 0, f"launches over the copy probes: dma_probe {launches}")
    best_big = max(big, key=lambda r: r["gbps"])
    errs = []
    dev = torch.device("cuda")
    for rec in recs + recs2 + [best_big]:
        case = rec["case"]
        g = torch.Generator(device=dev).manual_seed(0)
        srcs = dmabench.make_inputs(case, rec["total_bytes"], dev, g)
        carry = torch.full((8, 128), 1.0, device=dev)
        args = (srcs, carry, rec["chunk_rows"], case.touch_every)
        y = dma.dma_probe(*args, case.engine, case.depth, rec["unit"])
        again = dma.dma_probe(*args, case.engine, case.depth, rec["unit"])
        p = dma.plain_dma_probe(*args)
        torch.cuda.synchronize()
        err = float(max((y - p).abs().max(), (again - p).abs().max()))
        errs.append(err)
        rec["plain_ms"] = median_ms(lambda: dma.plain_dma_probe(*args), reps,
                                    graph=True)
        check(err == 0.0,
              f"dma {case.name}, {len(srcs)} x {srcs[0].numel() >> 18} MiB: "
              f"max abs err {err:.1e} over two calls (limit 0: integer "
              f"inputs); kernel {rec['ms'] * 1e3:.2f} us {rec['gbps']:.1f} "
              f"GB/s, plain (the touched rows only) "
              f"{rec['plain_ms'] * 1e3:.1f} us, bound "
              f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_rate']})")
        del srcs
    for engine in dma.ENGINES:
        mine = [r for r in recs if r["case"].engine == engine]
        mine_big = [r for r in big if r["case"].engine == engine]
        b32 = max(mine, key=lambda r: r["gbps"])
        b1g = max(mine_big, key=lambda r: r["gbps"])
        say(f"copy engine {engine}: best {b32['gbps']:.1f} GB/s at "
            f"{STREAM_MIB} MiB ({b32['name']}, in L2), {b1g['gbps']:.1f} GB/s "
            f"at {STREAM_BIG_MIB} MiB ({b1g['name']}, device memory: "
            f"{b1g['gbps'] / HBM_DATASHEET_GBPS:.1%} of the data sheet)")
    say(f"dma L2 read rate {l2['gbps']:.1f} GB/s ({l2['origin']}); the "
        f"probe's fixed cost {fixed['ms'] * 1e3:.2f} us (one 4 KB unit a "
        f"block)")
    in_l2 = {}
    for name in ("bulk whole 8MB", "bulk same 16MB"):
        r = next(r for r in recs2 if r["name"] == name)
        in_l2[name] = r
        say(f"dma {name}: {r['ms'] * 1e3:.2f} us against an L2 bound of "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bytes']} B at "
            f"{l2['gbps']:.1f} GB/s): {r['bound_ms'] / r['ms']:.1%} of the "
            f"bound; the fixed cost is {fixed['ms'] / r['ms']:.0%} of the "
            f"call; the HBM data sheet's {r['hbm_bound_ms'] * 1e3:.2f} us "
            f"is not a floor in L2")
    d2, d4 = in_l2["bulk whole 8MB"], in_l2["bulk same 16MB"]
    d3 = next(r for r in recs2 if r["name"] == "bulk multi 4x16MB")
    return l2, dict(name="dma_probe", route="cuda",
                source="tpu_amg_torch/csrc/dma.cu",
                replaces="tools/dmabench.py:39, tools/dmabench2.py:61, "
                         "tools/dmabench2.py:88, tools/dmabench2.py:130",
                launches=launches, max_abs_err=max(errs), ms=best_big["ms"],
                plain_ms=best_big["plain_ms"], bound_ms=best_big["bound_ms"],
                bound_by="bytes", library_ms=None,
                # D2-D4 (bulk); D2 and D4 bound over the L2 read rate
                d2_ms=d2["ms"], d2_bound_ms=d2["bound_ms"],
                d3_ms=d3["ms"], d3_bound_ms=d3["bound_ms"],
                d4_ms=d4["ms"], d4_bound_ms=d4["bound_ms"],
                l2_gbps=l2["gbps"], l2_origin=l2["origin"],
                fixed_ms=fixed["ms"])


def primitives_phase(reps):
    """Phase 12: the entry point at 4096 tiles; every op against its
    plain version on the inputs the entry point timed, at inner LO and
    HI; the gathers' wavefronts and design floor; the SASS counts of the
    LO and HI kernels.  Returns the kernels-line entry."""
    import torch

    from tpu_amg_torch.ops import primitives
    from tpu_amg_torch.tools import microbench_primitives
    from tpu_amg_torch.utils.timing import hbm_bound_ms, median_ms

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    reset_counts()
    recs, _ = microbench_primitives.run(["--reps", str(reps)])
    torch.cuda.synchronize()
    launches = primitives.primitive_probe_launches
    check(launches > 0, f"launches over the primitive probe: primitive_probe "
          f"{launches}")
    errs = []
    for rec in recs:
        op, tiles = rec["op"], rec["tiles"]
        # the entry point's inputs: make_inputs is seeded
        x, idx = primitives.make_inputs(op, tiles, dev)
        for inner in primitives.INNERS:
            y = primitives.primitive_probe(x, idx, op, inner)
            p = primitives.plain_primitive_probe(x, idx, op, inner)
            torch.cuda.synchronize()
            err = float((y.float() - p.float()).abs().max())
            scale = float(p.float().abs().max())
            # a fused multiply-add rounds once where the plain version
            # rounds twice; every other op is exact
            limit = 1e-6 * scale if op in ("fma", "gather_fma") else 0.0
            errs.append(err)
            check(err <= limit, f"primitive {op} at {tiles} tiles, inner "
                  f"{inner}: max abs err {err:.2e} (limit {limit:.1e})")
        if op == PRIMITIVE_OP:
            main_rec = rec
            main_rec["plain_ms"] = median_ms(
                lambda: primitives.plain_primitive_probe(
                    x, idx, op, primitives.HI), 2, graph=True)
            bytes_ms = hbm_bound_ms(x.numel() * x.element_size() * 2
                                    + idx.numel() * idx.element_size())
        del x, idx, y, p
    unfolded = primitives.sass_unfolded(primitives.sass_instruction_counts())
    check(all(ok for ok, _ in unfolded.values()),
          "SASS of the HI kernels (every step's gathers issued, no spills): "
          + "; ".join(desc for _, desc in unfolded.values()))
    by_op = {r["op"]: r for r in recs}
    for op in primitives.REPLICATED:
        r = by_op[op]
        say(f"primitive {op} at {r['tiles']} tiles, inner {primitives.HI}: "
            f"{r['hi_ms'] * 1e3:.1f} us, {r['ns_per_op']:.4f} ns/op against "
            f"a bound of {r['bound_ns_per_op']:.4f} "
            f"({r['bound_ns_per_op'] / r['ns_per_op']:.1%}); "
            f"{r['wavefronts']:.2f} wavefronts a gather (a host model of "
            f"the kernel's thread map, not a counter), design floor "
            f"{r['floor_ns_per_op']:.4f} ns/op")
    for r in recs:
        # a marginal op over its bound is reported, never clipped; the HI
        # call beside it, against the bound of its own 272 steps
        if r["ns_per_op"] < r["bound_ns_per_op"]:
            say(f"primitive {r['op']}: the marginal op {r['ns_per_op']:.4f} "
                f"ns/op reads {r['bound_ns_per_op'] / r['ns_per_op']:.1%} of "
                f"its bound {r['bound_ns_per_op']:.4f}; its HI call "
                f"{r['hi_ms'] * 1e3:.1f} us is "
                f"{r['hi_bound_ms'] / r['hi_ms']:.1%} of that call's bound "
                f"{r['hi_bound_ms'] * 1e3:.1f} us")
    rec = main_rec
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ops_ms = rec["tiles"] * primitives.op_bound_ns(
        PRIMITIVE_OP, sms, rec["clock_mhz"], primitives.HI) / 1e6
    say(f"primitive {PRIMITIVE_OP} at {rec['tiles']} tiles, inner "
        f"{primitives.HI}: kernel {rec['hi_ms'] * 1e3:.1f} us, plain "
        f"{rec['plain_ms'] * 1e3:.1f} us, bound "
        f"{max(ops_ms, bytes_ms) * 1e3:.1f} us (operations "
        f"{ops_ms * 1e3:.1f}, bytes {bytes_ms * 1e3:.1f}; SM clock "
        f"{rec['clock_mhz']:.0f} MHz)")
    pair = by_op["pair_gather"]
    return dict(name="primitive_probe", route="cuda",
                source="tpu_amg_torch/csrc/primitives.cu",
                replaces="tools/microbench_primitives.py:52",
                launches=launches, max_abs_err=max(errs), ms=rec["hi_ms"],
                plain_ms=rec["plain_ms"], bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=None,
                # pair_gather's time and marginal op
                pair_gather_ms=pair["hi_ms"],
                pair_gather_ns_per_op=pair["ns_per_op"],
                pair_gather_bound_ns_per_op=pair["bound_ns_per_op"])


def cli_phase():
    """Phase 13: the CLI (python -m tpu_amg_torch.tools.amg) on the card:
    the structured poisson3d(100), the SA default aniso2d, the MFEM
    fixture that the port's fixture writer makes in a temporary
    directory, the adaptive composite (--composite 2) on aniso2d(128)
    with random coefficients, whose peel tables it prints, elasticity3d,
    and classical AMG (--interpolation classical on poisson2d(64), and
    with --classical-opts on aniso2d(16)); each final
    line parsed and checked, the launch counts read over each run (the
    SA aniso2d, composite and elasticity runs in the setup workers,
    checked by :func:`cli_worker_phase`).  Then the block smoother (the
    CLI's default) on the fixture's hierarchy, on the card against the
    CPU.  Returns the launches over this process's CLI runs."""
    import collections

    import torch

    from tpu_amg_torch.linop import SparseOperator
    from tpu_amg_torch.ops import dia, spmv
    from tpu_amg_torch.solver import AMGSolver, SolverConfig
    from tpu_amg_torch.solvers import cg
    from tpu_amg_torch.utils.io import load_mfem_linear_system

    name = "fem_square_k100"
    with tempfile.TemporaryDirectory() as tmp:
        fixture = Path(tmp) / name
        subprocess.run([sys.executable, "-m",
                        "tpu_amg_torch.tools.make_fem_fixture", "--out",
                        str(fixture)], check=True, capture_output=True)
        cases = [
            # rtol 1e-6, at which the JAX package took 7 iterations, but
            # on b = A x_true from zero; the CLI solves b = ones from a
            # random x0, so the limit of twice 7 spans two protocols
            ("structured poisson3d(100)", ["--problem", "poisson3d", "--n",
                                           "100", "--structured", "--tol",
                                           "1e-6"], MAX_ITERS_STRUCTURED),
            ("SA MFEM fixture", ["--data-dir", str(fixture), "--name", name,
                                 "--coarsest-dim", "200"], None),
            # classical: the auto W-cycle; then MEASURED.md:582's
            # options on aniso2d(16), on two levels
            (f"classical poisson2d n={CLI_CLASSICAL_N}",
             ["--problem", "poisson2d", "--n", str(CLI_CLASSICAL_N),
              "--interpolation", "classical", "--smoother", "chebyshev"],
             None),
            ("classical aniso2d n=16 --classical-opts tau=1.3,max=2",
             ["--interpolation", "classical", "--classical-opts",
              "tau=1.3,max=2", "--n", "16", "--coarsest-dim", "100"], None),
        ]
        totals = collections.Counter()
        for label, argv, limit in cases:
            torch.cuda.synchronize()
            reset_counts()
            line, secs, text = run_cli("tpu_amg_torch.tools.amg", argv)
            torch.cuda.synchronize()
            counts = dict(csr_spmv_capped=spmv.csr_spmv_launches,
                          coo_patch=spmv.coo_patch_launches,
                          dia_spmv=dia.dia_spmv_launches)
            totals.update(counts)
            check_cli(label, argv, limit, line, secs, text, counts)
        # the setup profiler: cProfile over AMGSolver.setup (float32, the
        # float32 bootstrap) on unstructured_fem_system(128)
        torch.cuda.synchronize()
        reset_counts()
        line, secs, text = run_cli("tpu_amg_torch.tools.profile_setup",
                                   ["--side", str(PROFILE_SIDE), "--top",
                                    "15"])
        torch.cuda.synchronize()
        by_dtype = dict(spmv.csr_spmv_launches_by_dtype)
        f32 = by_dtype.get((torch.float32, torch.float32), 0)
        own = text[text.rfind("Ordered by: internal time"):].splitlines()
        say("profile_setup's top entries by own time:\n"
            + "\n".join(own[:20]))
        check(line.startswith("# setup phases: near_null ")
              and "Ordered by: cumulative time" in text and f32 > 0,
              f"python -m tpu_amg_torch.tools.profile_setup --side "
              f"{PROFILE_SIDE} --top 15: exit 0 in {secs:.1f} s; {line!r}; "
              f"K1 at (f32, f32) {f32} launches")
        system = load_mfem_linear_system(fixture, name)
    # the block smoother on the fixture: the card against the CPU, from
    # one hierarchy
    cfg = SolverConfig(smoother="block", smoothing_steps=3, coarsest_dim=100,
                       dense_threshold=100, device="cuda")
    s_gpu = AMGSolver.setup(system.matrix, cfg)
    mg_cpu = AMGSolver._mg_config(
        dataclasses.replace(cfg, device="cpu")).build(s_gpu.hierarchy)
    rng = np.random.default_rng(11)
    diffs = []
    for shape in ((system.matrix.nrows,), (system.matrix.nrows, 5)):
        v = rng.standard_normal(shape)
        zg = s_gpu.preconditioner(torch.from_numpy(v).cuda()).cpu()
        zc = mg_cpu(torch.from_numpy(v))
        diffs.append(float((zg - zc).abs().max() / zc.abs().max()))
    b = torch.from_numpy(system.rhs[:, 0])
    _, ig = s_gpu.solve(b, rtol=RTOL)
    _, ic = cg(SparseOperator.from_csr(system.matrix, "cpu"), b, mg_cpu,
               rtol=RTOL)
    check(max(diffs) <= 1e-10 and ig.converged and ig.iters == ic.iters,
          f"block smoother on the MFEM fixture (n={system.matrix.nrows}, "
          f"{s_gpu.hierarchy.num_levels} levels): V-cycle rel diff card "
          f"against CPU {diffs[0]:.2e} (mv), {diffs[1]:.2e} (mm, k=5) "
          f"(limit 1e-10); PCG card {ig.iters} / CPU {ic.iters} iterations")
    return totals


def check_cli(label, argv, limit, line, secs, text, counts) -> None:
    """One CLI run's final line parsed and checked, with its launches."""
    fields = line.split()
    try:
        cg_iters, sli_iters = int(fields[0]), int(fields[1])
        e_norm, oc = float(fields[2]), float(fields[3])
        formed = len(fields) == 4
    except (IndexError, ValueError):
        cg_iters = sli_iters = 0
        e_norm = oc = float("nan")
        formed = False
    structured = "--structured" in argv
    composite = "--composite" in argv
    if composite:
        tables = text[text.find("Composite PCG results:"):]
        say(tables[:tables.rfind("+") + 1])
    check(formed and cg_iters > 0 and sli_iters > 0
          and 0.0 < e_norm < 1.0
          and (np.isnan(oc) if structured or composite else oc >= 1.0)
          and (limit is None or cg_iters <= limit)
          and (not composite or "Composite stationary results:" in text)
          and counts["csr_spmv_capped"] > 0
          and (counts["dia_spmv"] > 0 or not structured),
          f"CLI {label}: final line {line!r} (cg_iters {cg_iters}"
          + ("" if limit is None else f", limit {limit}")
          + f"), {secs:.1f} s; launches " + ", ".join(
              f"{k} {v}" for k, v in counts.items()))


def cli_job(argv) -> dict:
    """One CLI run in a setup worker (CLI_WORKER_CASES): its launch
    counts set to 0 just before it and read just after it."""
    import torch

    from tpu_amg_torch.ops import dia, spmv

    reset_counts()
    line, secs, text = run_cli("tpu_amg_torch.tools.amg", argv)
    torch.cuda.synchronize()
    return dict(line=line, secs=secs, text=text, counts=dict(
        csr_spmv_capped=spmv.csr_spmv_launches,
        coo_patch=spmv.coo_patch_launches, dia_spmv=dia.dia_spmv_launches))


def cli_worker_phase(jobs, totals) -> None:
    """Phase 13's CLI runs of the setup workers (CLI_WORKER_CASES),
    checked as the others, and the launches over every CLI run."""
    t0 = time.perf_counter()
    for label, argv, limit in CLI_WORKER_CASES:
        res = jobs[f"cli {label}"].get(timeout=JOB_WAIT)
        totals.update(res["counts"])
        check_cli(label + " (a setup worker)", argv, limit, res["line"],
                  res["secs"], res["text"], res["counts"])
    say(f"phase 13: the CLI runs of the setup workers done "
        f"{time.perf_counter() - t0:.1f} s after phase 18")
    check(min(totals.values()) > 0, "launches over the CLI runs: "
          + ", ".join(f"{k} {v}" for k, v in totals.items()))


def dia_to_csr(dia):
    """The host CSR of a DIA matrix (its stored nonzeros)."""
    from tpu_amg_torch.sparse.csr import CSR

    n = dia.shape[0]
    offsets = np.asarray(dia.offsets, dtype=np.int64)
    rows = np.tile(np.arange(n, dtype=np.int64), len(offsets))
    cols = rows + np.repeat(offsets, n)
    vals = dia.data.double().cpu().numpy().ravel()
    keep = (cols >= 0) & (cols < n) & (vals != 0)
    return CSR.from_coo(rows[keep], cols[keep], vals[keep], dia.shape)


def dia_kernel_cases(name, dia64, csr, reps, results, ks=(1, 7, 8),
                     dtypes=None):
    """K3 against its plain version on one DIA matrix, float64 and
    float32 (or ``dtypes``), and bitwise against its first design and
    against a second call; device times of K3 and its first design
    (in turns, A B B A), the plain version and K1 + K2 on the same
    matrix as a capped CSR (CUDA graph replays); below k = TILED_MIN_K,
    where K3 runs its row-chunk design, also the band-tile design
    (uncounted, not routed)."""
    import torch

    from tpu_amg_torch.ops import dia as dia_ops
    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.utils.timing import (alternating_ms, hbm_bound_ms,
                                            median_ms)

    n, n_diags = dia64.shape[0], len(dia64.offsets)
    for dtype in dtypes or (torch.float64, torch.float32):
        dname = str(dtype).replace("torch.", "")
        mat = dia64 if dtype == torch.float64 else dia64.astype(dtype)
        capped = spmv.CappedCSR.from_csr(csr, "cuda", dtype)
        lib = torch_csr(*(torch.from_numpy(a).cuda() for a in
                          (csr.indptr, csr.indices)),
                        torch.from_numpy(csr.data).to("cuda", dtype),
                        csr.shape)
        for k in ks:
            g = torch.Generator(device="cuda").manual_seed(k)
            shape = (n,) if k == 1 else (n, k)
            x = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            y = dia_ops.dia_spmv(mat, x)
            again = dia_ops.dia_spmv(mat, x)
            first = dia_ops.launch_first_design(mat, x)
            tiles = dia_ops.launch_band_tiles(mat, x)
            p = dia_ops.plain_dia_spmv(mat, x)
            yc = spmv.spmv(capped, x)
            torch.cuda.synchronize()
            same = (torch.equal(y, first) and torch.equal(y, again)
                    and torch.equal(tiles, first))
            scale = max(float(p.abs().max()), 1e-300)
            err = float((y - p).abs().max())
            rel_csr = float((yc - p).abs().max()) / scale
            plan = dia_ops.plan_for(mat, x)
            t, tf = alternating_ms(
                [lambda: dia_ops.dia_spmv(mat, x),
                 lambda: dia_ops.launch_first_design(mat, x)], reps)
            tiled = k >= dia_ops.TILED_MIN_K
            tt = t if tiled else median_ms(
                lambda: dia_ops.launch_band_tiles(mat, x), reps, graph=True)
            tp = median_ms(lambda: dia_ops.plain_dia_spmv(mat, x), reps,
                           graph=True)
            tc = median_ms(lambda: spmv.spmv(capped, x), reps, graph=True)
            # the library's SpMV or SpMM on the same matrix from CSR
            # storage
            tl = median_ms(lambda: lib @ x, reps, graph=True)
            isz = x.element_size()
            dia_bytes = (n_diags * n + 2 * n * k) * isz
            csr_bytes = (capped.nnz * (isz + 4) + 8 * (n + 1)
                         + 2 * n * k * isz)
            if tiled:
                design = f"band tiles T={plan.tile}, {len(plan.bands)} bands"
            else:
                rp = dia_ops.row_plan_for(mat, x)
                design = (f"row-chunk R={rp.rows_per_thread} C={rp.cols} x "
                          f"{rp.threads} threads, U={rp.chunk}")
            check(
                err / scale <= TOL[dname] and rel_csr <= TOL[dname] and same,
                f"K3 {name} {dname} k={k}: n {n}, {n_diags} diagonals, "
                f"nnz {dia64.nnz}: max rel err {err / scale:.3e} (K1+K2 "
                f"{rel_csr:.3e}; limit {TOL[dname]:.0e}); bitwise equal to "
                f"the first design, to a second call and the band tiles to "
                f"the first design: {same}; K3 ({design}) {t * 1e3:.2f} us "
                f"({dia_bytes / t / 1e6:.0f} GB/s of {dia_bytes / 1e6:.1f} "
                f"MB), first design {tf * 1e3:.2f} us"
                + ("" if tiled else f", band tiles (not routed; T="
                   f"{plan.tile}, {len(plan.bands)} bands) {tt * 1e3:.2f} us")
                + f", plain {tp * 1e3:.2f} us, K1+K2 as CSR {tc * 1e3:.2f} "
                f"us ({csr_bytes / tc / 1e6:.0f} GB/s of "
                f"{csr_bytes / 1e6:.1f} MB); library CSR @ x "
                f"{tl * 1e3:.2f} us; bound {hbm_bound_ms(dia_bytes) * 1e3:.2f} "
                f"us",
            )
            results.append(dict(case=name, dtype=dname, k=k, err=err, ms=t,
                                first_ms=tf, tiled_ms=tt, plain_ms=tp,
                                csr_ms=tc, bytes=dia_bytes,
                                csr_bytes=csr_bytes, lib_ms=tl,
                                bound_ms=hbm_bound_ms(dia_bytes), n=n,
                                diagonals=n_diags, bands=len(plan.bands),
                                design=design))


def level_lines(mg):
    """One description per level of a multigrid: rows, format,
    diagonals, stored entries."""
    import torch

    from tpu_amg_torch.linop import DenseOperator
    from tpu_amg_torch.sparse.dia import DIA

    lines = []
    for lvl, level in enumerate(mg.levels):
        op = level.a
        if isinstance(op, DenseOperator):
            desc = f"dense, nnz {int(torch.count_nonzero(op.mat))}"
        elif isinstance(op.mat, DIA):
            desc = f"DIA (K3), {len(op.mat.offsets)} diagonals, nnz {op.mat.nnz}"
        else:
            desc = (f"CSR (K1+K2), nnz {op.mat.nnz} "
                    f"({op.mat.nnz / op.shape[0]:.1f}/row), "
                    f"tail {op.mat.n_tail}")
        lines.append(f"  level {lvl}: n={op.shape[0]} {desc}")
    lines.append(f"  coarse: n={mg.coarse_solver.shape[0]} dense Cholesky "
                 f"inverse")
    return lines


def shape_counts() -> dict:
    """K1's, K2's and K3's launches by (rows, cols, k) since the last
    reset."""
    import collections

    from tpu_amg_torch.ops import dia, spmv

    return {"K1": collections.Counter(spmv.csr_spmv_launches_by_shape),
            "K2": collections.Counter(spmv.coo_patch_launches_by_shape),
            "K3": collections.Counter(dia.dia_spmv_launches_by_shape),
            "K1 designs": collections.Counter(
                spmv.csr_spmv_launches_by_design)}


def say_shape_counts(label: str, counts: dict) -> None:
    for kernel, by_shape in counts.items():
        if kernel == "K1 designs":
            say(f"{label}: K1 launches by design {dict(sorted(by_shape.items()))}")
            continue
        say(f"{label}: {kernel} {sum(by_shape.values())} launches; by "
            f"(rows, cols, k): " + ", ".join(
                f"{key} {v}" for key, v in sorted(by_shape.items())))


def composite_matrices(hierarchies, pc) -> dict:
    """name -> (host CSR, the float64 matrix on the card the composite
    runs where it runs one, else None) for every A, P and R of every
    component (``c1 A0`` …) and the composite's own A (``A``)."""
    from tpu_amg_torch.linop import SparseOperator

    out = {"A": (hierarchies[0].matrices[0], pc.a.mat)}
    for c, (h, mg) in enumerate(zip(hierarchies, pc.components)):
        for lvl in range(h.num_levels):
            level = mg.levels[lvl] if lvl < len(mg.levels) else None
            for letter, host in (("A", h.matrices), ("P", h.interpolations),
                                 ("R", h.restrictions)):
                if lvl >= len(host):
                    continue
                op = None if level is None else getattr(level,
                                                        letter.lower())
                mat = op.mat if isinstance(op, SparseOperator) else None
                out[f"c{c + 1} {letter}{lvl}"] = (host[lvl], mat)
    return out


def adaptive_kernel_cases(matrices, counts, reps, results, dia_results):
    """K1 + K2 and K3 against their plain versions at every (matrix, k)
    the adaptive path launched them on, float64 and float32, timed as
    phase 3 and phase 8 time them; returns the names of the CSR cases
    and of the DIA ones, and the CSR cases' float64 matrices by name."""
    import torch

    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.sparse.dia import DIA, try_from_csr

    ks_csr, ks_dia = {}, {}
    for kernel in ("K1", "K2", "K3"):
        for rows, cols, k in counts[kernel]:
            # the first matrix of that shape: the components share A
            name = next(n for n, (csr, _) in matrices.items()
                        if csr.shape == (rows, cols))
            (ks_dia if kernel == "K3" else ks_csr).setdefault(
                name, set()).add(k)
    for name, ks in sorted(ks_dia.items()):
        csr, mat = matrices[name]
        if not isinstance(mat, DIA):  # a level the multigrid keeps dense
            mat = try_from_csr(csr, "cuda", torch.float64, max_diags=None)
        dia_kernel_cases(f"adaptive {name}", mat, csr, reps, dia_results,
                         sorted(ks))
    csr_mats = {}
    for name, ks in sorted(ks_csr.items()):
        csr, mat = matrices[name]
        if not isinstance(mat, spmv.CappedCSR):
            mat = spmv.CappedCSR.from_csr(csr, "cuda", torch.float64)
        csr_mats[f"adaptive {name}"] = mat
        kernel_cases(
            f"adaptive {name}",
            {torch.float64: mat,
             torch.float32: spmv.CappedCSR.from_csr(csr, "cuda",
                                                    torch.float32)},
            reps, results, sorted(ks))
    return ({f"adaptive {n}" for n in ks_csr},
            {f"adaptive {n}" for n in ks_dia}, csr_mats)


def launch_counters(tables: dict) -> dict:
    """A worker's launch tables (``bootstrap_study.launch_tables``) as
    :func:`shape_counts` gives them."""
    return {"K1": collections.Counter(tables["K1"]["by_shape"]),
            "K2": collections.Counter(tables["K2"]["by_shape"]),
            "K3": collections.Counter(tables["K3"]["by_shape"]),
            "K1 designs": collections.Counter(tables["K1"]["by_design"])}


def adaptive_phase(setup, reps, results, dia_results) -> dict:
    """Phase 14: the adaptive composite at 262,144 dofs (aniso2d(512),
    random coefficients, 2 components, the CLI's defaults) through
    AMGSolver.setup(method="adaptive") in a worker process (``setup``:
    its phases, launches by shape, peak memory, checkpoint and apply on
    a seeded vector); the composite checkpoint loaded here, its apply
    bitwise the worker's; each component's levels; the peel study (2 ->
    1 components, PCG and stationary to 1e-12); 3 PCG solves and a
    stationary one, eager and compiled, bitwise equal; the composite
    V-cycle's times; K1, K2 and K3 against their plain versions at every
    (matrix, k) the path launched; a small composite on the card against
    the CPU; rand-SVD."""
    import torch

    from tpu_amg_torch.linop import SparseOperator
    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.preconditioners import Composite
    from tpu_amg_torch.solver import AMGSolver
    from tpu_amg_torch.solvers import cg
    from tpu_amg_torch.tools import amg as amg_cli
    from tpu_amg_torch.tools import rand_svd_test
    from tpu_amg_torch.tools.bootstrap_study import adaptive_config
    from tpu_amg_torch.utils.problems import anisotropic_diffusion_2d
    from tpu_amg_torch.utils.timing import median_ms

    t0 = time.perf_counter()
    a = anisotropic_diffusion_2d(ADAPTIVE_N, epsilon=1e-3, theta=np.pi / 6,
                                 coefficient="random")
    say(f"problem: anisotropic_diffusion_2d({ADAPTIVE_N}, epsilon=1e-3, "
        f"theta=pi/6, coefficient=random): n={a.nrows} nnz={a.nnz} built "
        f"in {time.perf_counter() - t0:.1f} s")
    say(setup_line("adaptive", setup))
    cfg = adaptive_config("cuda")
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = AMGSolver.load(setup["ckpt"], a, cfg)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    setup_counts = launch_counters(setup["counts"])
    pc = solver.preconditioner
    hs = solver.component_hierarchies
    # the composite checkpoint: the loaded apply against the worker's
    # original on the same seeded vector
    r = torch.from_numpy(np.random.default_rng(
        CHECKPOINT_PROBE_SEED).standard_normal(a.nrows)).to(dev)
    same = bool(np.array_equal(
        solver.apply_preconditioner(r).cpu().numpy(), setup["probe"]))
    check(same and isinstance(pc, Composite),
          f"composite checkpoint: saved by the worker in "
          f"{setup['save_s']:.1f} s ({Path(setup['ckpt']).stat().st_size / 1e6:.1f}"
          f" MB), load + {ADAPTIVE_COMPONENTS} multigrid builds here "
          f"{t_load:.1f} s; the loaded composite's apply is bitwise equal "
          f"to the original's (the worker's) on a seeded vector: {same}")
    for c, h in enumerate(hs):
        say(f"  component {c + 1}: {h.num_levels} levels, op complexity "
            f"{h.op_complexity():.3f}, grid complexity "
            f"{h.grid_complexity():.3f}; rows "
            + " / ".join(str(m.nrows) for m in h.matrices))
    say_shape_counts("adaptive setup", setup_counts)
    check(isinstance(pc, Composite) and len(pc.components)
          == ADAPTIVE_COMPONENTS and isinstance(pc.a, SparseOperator)
          and {63, 64} <= {key[2] for key in setup_counts["K3"]}
          and 64 in {key[2] for key in setup_counts["K1"]},
          f"adaptive setup: {len(pc.components)} components; the fine A is "
          f"{type(pc.a.mat).__name__}; K3 ran at k = "
          f"{sorted({key[2] for key in setup_counts['K3']})}, K1 at k = "
          f"{sorted({key[2] for key in setup_counts['K1']})} (expected 63 "
          f"and 64 on K3, 64 on K1)")

    # the peel study, eager: 2 -> 1 components, b = ones from a seeded x0
    torch.cuda.synchronize()
    reset_counts()
    rhs = torch.ones(a.nrows, dtype=torch.float64, device=dev)
    x0 = torch.randn(a.nrows, generator=torch.Generator().manual_seed(7),
                     dtype=torch.float64).to(dev)
    t0 = time.perf_counter()
    pcg_rows, sli_rows = amg_cli.test_composite(pc, rhs, x0,
                                                ADAPTIVE_MAXITER, ADAPTIVE_TOL)
    torch.cuda.synchronize()
    t_peel = time.perf_counter() - t0
    say(amg_cli.composite_tables(pcg_rows, sli_rows))
    two, one = pcg_rows
    check(two[1] < ADAPTIVE_MAXITER and two[5] <= ADAPTIVE_TOL
          and two[1] < one[1] and two[1] <= ADAPTIVE_MAX_PCG,
          f"peel study ({t_peel:.1f} s): PCG to {ADAPTIVE_TOL:.0e} with "
          f"{two[0]} components {two[1]} iterations (final rel residual "
          f"{two[5]:.3e}; limit {ADAPTIVE_MAX_PCG}, twice the JAX package's "
          f"64), with {one[0]} {one[1]} (JAX 686); stationary {sli_rows[0][1]}"
          f" and {sli_rows[1][1]} iterations (final rel residual "
          f"{sli_rows[0][5]:.3e}, {sli_rows[1][5]:.3e})")

    # 3 PCG solves and a stationary one, eager and compiled
    a_mat = solver.op.mat
    solve_s, graph_s = [], []
    for i in range(3):
        x_true = np.random.default_rng(200 + i).standard_normal(a.nrows)
        b = solver.op.mv(torch.from_numpy(x_true).to(dev))
        pair = eager_and_compiled(solver, b, "cg", RTOL, 500)
        x, info, _ = pair[1]
        solve_s.append(pair[0][2])
        graph_s.append(pair[1][2])
        true_rel = float(torch.linalg.vector_norm(b - solver.op.mv(x))
                         / torch.linalg.vector_norm(b))
        check(info.converged and true_rel <= 1.01 * RTOL
              and tuple(x.shape) == (a.nrows,) and bool(torch.isfinite(x).all()),
              f"adaptive solve {i}: {info.iters} iterations to rtol "
              f"{RTOL:.0e}, true relative residual {true_rel:.3e}")
        check_same_solve(f"adaptive PCG solve {i}", pair, first=i == 0)
    pair = eager_and_compiled(solver, b, "stationary", RTOL,
                              ADAPTIVE_STATIONARY_MAX)
    say(f"adaptive stationary solve to rtol {RTOL:.0e} (at most "
        f"{ADAPTIVE_STATIONARY_MAX}): {pair[1][1].iters} iterations, "
        f"relative residual {pair[1][1].final_res / float(torch.linalg.vector_norm(b)):.3e}")
    check_same_solve("adaptive stationary solve", pair, first=True)
    del pair, x
    torch.cuda.synchronize()
    solve_counts = shape_counts()
    peak = torch.cuda.max_memory_allocated()
    say_shape_counts("adaptive peel study and solves", solve_counts)
    check(sum(solve_counts["K1"].values()) > 0
          and sum(solve_counts["K3"].values()) > 0,
          "adaptive path: K1 and K3 launched in the solves; peak device "
          f"memory with the graphs' pools {peak / 1e9:.2f} GB")

    # the composite V-cycle: enqueued from Python, and the device alone
    t_vc = median_ms(lambda: pc.mv(r), 20)
    t_vc_dev = median_ms(lambda: pc.mv(r), 20, graph=True)
    say(f"adaptive composite V-cycle ({2 * ADAPTIVE_COMPONENTS - 1} "
        f"component V-cycles, {2 * ADAPTIVE_COMPONENTS - 2} A applies): "
        f"{t_vc:.3f} ms as the solve runs it (enqueued from Python), "
        f"{t_vc_dev:.3f} ms on the device (CUDA graph replay); PCG solves "
        "eager " + ", ".join(f"{s:.4f}" for s in solve_s) + " s, compiled "
        + ", ".join(f"{s:.4f}" for s in graph_s) + " s")

    # where a component V-cycle's device time goes: each level's
    # smoother (the block smoother: a gather, a batched matmul by the
    # block inverses and a scatter a size bucket) and A, one apply each
    parts = []
    for lvl, level in enumerate(pc.components[0].levels):
        v = torch.randn(level.a.shape[0], dtype=torch.float64,
                        generator=torch.Generator().manual_seed(lvl)).to(dev)
        t_s = median_ms(lambda lv=level, v=v: lv.smoother.mv(v), 20,
                        graph=True)
        t_a = median_ms(lambda lv=level, v=v: lv.a.mv(v), 20, graph=True)
        buckets = getattr(level.smoother, "buckets", ())
        inv_mb = sum(b.inv_blocks.numel() * b.inv_blocks.element_size()
                     for b in buckets) / 1e6
        parts.append(f"level {lvl} (n={level.a.shape[0]}): smoother "
                     f"{t_s * 1e3:.1f} us ({len(buckets)} size buckets, "
                     f"{inv_mb:.1f} MB of block inverses), A {t_a * 1e3:.1f} us")
    say(f"component 1's V-cycle by level, device time of one apply (CUDA "
        f"graph replays; {pc.components[0].smoothing_steps} smoothing steps "
        f"before and after, each a smoother and an A apply): "
        + "; ".join(parts))

    # the kernels at every (matrix, k) the path launched
    counts = {k: setup_counts[k] + solve_counts[k] for k in setup_counts}
    matrices = composite_matrices(hs, pc)
    csr_cases, dia_cases, csr_mats = adaptive_kernel_cases(
        matrices, counts, reps, results, dia_results)
    k64 = max((c for c in results if c["case"] in csr_cases
               and c["dtype"] == "float64" and c["k"] == 64),
              key=lambda c: c["k1_bytes"])
    fine = {(c["dtype"], c["k"]): c for c in dia_results
            if c["case"] in dia_cases}
    for (dname, k), c in sorted(fine.items()):
        if k == 1:
            continue
        say(f"K3 at k={k} {dname} on the fine A ({c['bands']} bands): "
            f"{c['ms'] * 1e3:.2f} us against a bound of "
            f"{c['bound_ms'] * 1e3:.2f} us ({c['bound_ms'] / c['ms']:.1%} of "
            f"it; half of it {2e3 * c['bound_ms']:.2f} us); the first design "
            f"{c['first_ms'] * 1e3:.2f} us, K1+K2 as CSR "
            f"{c['csr_ms'] * 1e3:.2f} us, the library's SpMM "
            f"{c['lib_ms'] * 1e3:.2f} us")
    d64 = fine[("float64", 64)]

    # a small composite on the card against the same hierarchies on the
    # CPU (the plain versions)
    small = anisotropic_diffusion_2d(ADAPTIVE_SMALL_N, coefficient="random")
    scfg = adaptive_config("cuda", coarsest_dim=100, dense_threshold=200)
    s_gpu = AMGSolver.setup(small, scfg)
    twin = Composite.from_hierarchies(
        small, s_gpu.component_hierarchies,
        AMGSolver._mg_config(dataclasses.replace(scfg, device="cpu")))
    rng = np.random.default_rng(11)
    diffs = []
    for shape in ((small.nrows,), (small.nrows, 5)):
        v = rng.standard_normal(shape)
        zg = s_gpu.preconditioner(torch.from_numpy(v).to(dev)).cpu()
        zc = twin(torch.from_numpy(v))
        diffs.append(float((zg - zc).abs().max() / zc.abs().max()))
    b_np = rng.standard_normal(small.nrows)
    _, ig = s_gpu.solve(b_np, rtol=RTOL)
    _, ic = cg(twin.a, torch.from_numpy(b_np), twin, rtol=RTOL)
    check(max(diffs) <= 1e-10 and ig.converged and ig.iters == ic.iters,
          f"small composite aniso2d({ADAPTIVE_SMALL_N}) random, "
          f"{len(s_gpu.component_hierarchies)} components: apply rel diff "
          f"card against CPU {diffs[0]:.2e} (mv), {diffs[1]:.2e} (mm, k=5) "
          f"(limit 1e-10); PCG card {ig.iters} / CPU {ic.iters} iterations")
    # rand-SVD on the card
    svd = rand_svd_test.run("cuda")
    check(svd["score"] >= 0.99,
          f"rand-SVD (200 x 150, k=50) on the card: U alignment "
          f"{svd['align_u']:.6f}, V {svd['align_v']:.6f}, sigma ratio "
          f"{svd['sigma_ratio']:.6f}, combined score {svd['score']:.6f} "
          f"(limit 0.99)")
    return dict(counts=counts, k64=k64, d64=d64, csr_cases=csr_cases,
                csr_mats=csr_mats, near_null_s=setup["seconds"]["near_null"],
                dia_cases=dia_cases, solver=solver, small=(s_gpu, twin),
                peel_iters=two[1])


def say_adaptive_excess(adaptive, results, dia_results) -> None:
    """K1's, K2's and K3's launches x (time - bound) on the adaptive path,
    float64, once the rows in L2 carry their L2 bound."""
    counts = adaptive["counts"]
    for kernel, key in (("K1", "k1"), ("K2", "k2")):
        say_excess(kernel, key, "the adaptive path", counts[kernel], results,
                   adaptive["csr_cases"])
    excess, total = [], 0.0
    for shape, n in sorted(counts["K3"].items()):
        c = next(c for c in dia_results if c["case"] in adaptive["dia_cases"]
                 and c["dtype"] == "float64" and c["k"] == shape[2])
        ms = n * (c["ms"] - c["bound_ms"])
        total += ms
        excess.append(f"k={shape[2]} {shape}: {n} x ({c['ms'] * 1e3:.2f} - "
                      f"{c['bound_ms'] * 1e3:.2f} us) = {ms:.3f} ms")
    say(f"K3 on the adaptive path, launches x (time - bound), float64: "
        f"{total:.3f} ms in all; " + "; ".join(excess))


# ---- phases 16-17: block-3 elasticity and the float32 bootstrap

class KeepLog(logging.Handler):
    """Keeps the messages of the loggers it is added to, at INFO."""

    def __init__(self, *names):
        super().__init__()
        self.lines = []
        for name in names:
            logger = logging.getLogger(name)
            logger.setLevel(logging.INFO)
            logger.addHandler(self)

    def emit(self, record):
        self.lines.append(record.getMessage())


def classical_argv(side: int) -> list:
    """Phase 18's CLI arguments: poisson2d(side), classical, Chebyshev,
    every other option the CLI's default (MEASURED.md:428-429)."""
    return ["--problem", "poisson2d", "--n", str(side), "--interpolation",
            "classical", "--smoother", "chebyshev", "--device", "cuda"]


def classical_setup(side: int, ckpt: str) -> dict:
    """Phase 18's setup, in a worker process: the CLI's own configs and
    setup (tools.amg.configs and build_hierarchy: the near-null
    bootstrap on the card, the host hierarchy) of poisson2d(side), its
    launch counts set to 0 just before it and read just after it, the
    classical module's and the hierarchy's log lines (each CR round's
    reduction and C count, each level's seconds by step), and the
    hierarchy saved to ``ckpt``."""
    import torch

    from tpu_amg_torch.tools import amg, bootstrap_study
    from tpu_amg_torch.utils import checkpoint

    args = amg.parse_args(classical_argv(side))
    a, _ = amg.load_problem(args)
    hier_cfg, _ = amg.configs(args)
    log = KeepLog("tpu_amg_torch.interpolation.classical",
                  "tpu_amg_torch.hierarchy")
    torch.cuda.synchronize()
    bootstrap_study.reset_launch_counts()
    t0 = time.perf_counter()
    h, seconds = amg.build_hierarchy(
        a, args, hier_cfg, torch.Generator().manual_seed(args.seed))
    torch.cuda.synchronize()
    out = dict(side=side, setup_s=time.perf_counter() - t0, seconds=seconds,
               counts=bootstrap_study.launch_tables(), log=log.lines,
               rows=[m.nrows for m in h.matrices])
    t0 = time.perf_counter()
    checkpoint.save_hierarchy(ckpt, h)
    out["save_s"] = time.perf_counter() - t0
    return out


def start_setup_jobs(elasticity_side: int, sa_side: int, ckpt: str,
                     classical_ckpt: str, workdir: str,
                     adaptive_side: int = ADAPTIVE_N):
    """The setups phases 14 and 16-18 read, in processes beside the main
    one (host setup is single-threaded; the card is shared).  Phase 14's
    float64 adaptive composite, as tools.bootstrap_study runs it (its
    checkpoint under ``workdir`` and its apply on the
    CHECKPOINT_PROBE_SEED vector), in a process of its own with the main
    process's thread pools: the block smoother's host factorizations
    round by the number of BLAS threads, and phase 14 holds the
    checkpoint it loads bitwise to that apply.  The rest on SETUP_WORKERS
    workers of WORKER_THREADS threads: first phase 18's classical setup
    (:func:`classical_setup`); then the float64 elasticity setup (its
    checkpoint for phase 16) and the float32-bootstrap setups of the SA,
    elasticity and adaptive problems, each with its solves; then phase
    13's CLI_WORKER_CASES (:func:`cli_job`); then phase 20's two setups
    (:func:`slice14_setup`: the unstructured bench's and the real FEM's,
    the fixture written and the checkpoints saved under ``workdir``).
    Returns ([pools], {name: AsyncResult})."""
    import multiprocessing

    from tpu_amg_torch.tools import bootstrap_study

    jobs = {
        "adaptive f64": dict(kind="adaptive", side=adaptive_side,
                             bootstrap="float64",
                             ckpt=str(Path(workdir) / "composite.npz"),
                             probe_seed=CHECKPOINT_PROBE_SEED),
        "elasticity f64": dict(kind="elasticity", side=elasticity_side,
                               bootstrap="float64", ckpt=ckpt),
        "SA f32": dict(kind="sa", side=sa_side, bootstrap="float32",
                       rhs_seeds=(100,)),
        "elasticity f32": dict(kind="elasticity", side=elasticity_side,
                               bootstrap="float32", rhs_seeds=(100,)),
        "adaptive f32": dict(kind="adaptive", side=adaptive_side,
                             bootstrap="float32"),
    }
    context = multiprocessing.get_context("spawn")
    own = context.Pool(1)
    results = {"adaptive f64": own.apply_async(
        bootstrap_study.setup_job, (jobs.pop("adaptive f64"),))}
    saved = {var: os.environ.get(var) for var in THREAD_VARS}
    os.environ.update({var: str(WORKER_THREADS) for var in THREAD_VARS})
    try:  # the workers start here, reading these variables
        pool = context.Pool(SETUP_WORKERS)
    finally:
        for var, value in saved.items():
            if value is None:
                os.environ.pop(var)
            else:
                os.environ[var] = value
    results["classical"] = pool.apply_async(
        classical_setup, (CLASSICAL_SIDE, classical_ckpt))
    results.update({name: pool.apply_async(bootstrap_study.setup_job, (job,))
                    for name, job in jobs.items()})
    results.update({f"cli {label}": pool.apply_async(cli_job, (argv,))
                    for label, argv, _ in CLI_WORKER_CASES})
    for kind, side in (("unstructured", UNSTRUCTURED_SIDE),
                       ("fem", FEM_SIDE_SOLVE)):
        results[f"phase 20 {kind}"] = pool.apply_async(
            slice14_setup,
            (kind, side, str(Path(workdir) / f"{kind}.npz"), workdir))
    return [own, pool], results


def setup_line(label: str, res: dict) -> str:
    return (f"{label}: setup {res['setup_s']:.1f} s ("
            + ", ".join(f"{k} {v:.1f} s" for k, v in res["seconds"].items())
            + f"; a worker process, bootstrap {res['bootstrap']}); peak "
            f"device memory {res['peak_gb']:.2f} GB; rows "
            + "; ".join(" / ".join(map(str, r)) for r in res["rows"]))


def say_launch_tables(label: str, tables: dict) -> None:
    for kernel, t in tables.items():
        say(f"{label}: {kernel} {sum(t['by_shape'].values())} launches; by "
            f"(values, vectors) {t['by_dtype']}; by (rows, cols, k): "
            + ", ".join(f"{key} {v}" for key, v in sorted(t["by_shape"].items())))
    say(f"{label}: K1 launches by design "
        f"{dict(sorted(tables['K1']['by_design'].items()))}")


def elasticity_phase(setup: dict, ckpt: str, reps: int, results) -> dict:
    """Phase 16: block-3 elasticity at unstructured_elasticity_3d(side)
    (192,000 dofs at side 40) with elasticity_3d_config, float64: the
    setup of a worker process (its phases, launches and checkpoint), the
    checkpoint loaded here, each level's format, rows, entries and block
    size, 2 PCG solves of A x = A x_true to rtol 1e-6, eager and
    compiled (bitwise equal, at most 66 iterations: twice the JAX
    package's 33 at 499,125 dofs), the V-cycle's times, and K1 + K2
    against their plain versions at every (matrix, k) the path launched
    them on, float64, and at the float32 bootstrap's k = 11 on A0."""
    import torch

    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.solver import AMGSolver, elasticity_3d_config
    from tpu_amg_torch.tools.solve3d import level_table
    from tpu_amg_torch.utils.problems import unstructured_elasticity_3d
    from tpu_amg_torch.utils.timing import median_ms

    side = setup["side"]
    t0 = time.perf_counter()
    a = unstructured_elasticity_3d(side)
    say(f"problem: unstructured_elasticity_3d({side}): n={a.nrows} "
        f"nnz={a.nnz} block={a.block_size} built in "
        f"{time.perf_counter() - t0:.1f} s")
    say(setup_line("elasticity", setup)
        + f"; checkpoint saved in {setup['save_s']:.1f} s")
    say_launch_tables("elasticity setup", setup["counts"])
    cfg = elasticity_3d_config("cuda")
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    solver = AMGSolver.load(ckpt, a, cfg)
    torch.cuda.synchronize()
    h = solver.hierarchy
    say(f"elasticity checkpoint loaded, multigrid built: "
        f"{time.perf_counter() - t0:.1f} s; {h.num_levels} levels, op "
        f"complexity {h.op_complexity():.3f}, grid complexity "
        f"{h.grid_complexity():.3f}")
    for line in level_table(solver.preconditioner, h):
        say("  " + line)
    setup_k1 = setup["counts"]["K1"]["by_shape"]
    k_boot = cfg.coarsening_near_null_dim - 1
    check(h.matrices[0].block_size == 3 and h.num_levels >= 2
          and h.matrices[1].block_size == cfg.interp_near_null_dim
          and isinstance(solver.op.mat, spmv.CappedCSR)
          and (a.nrows, a.nrows, k_boot) in setup_k1,
          f"elasticity hierarchy: block sizes "
          f"{[m.block_size for m in h.matrices]} (3, then the candidate "
          f"dimension {cfg.interp_near_null_dim}); the fine A is "
          f"{type(solver.op.mat).__name__}; the bootstrap's SpMM ran K1 "
          f"at k = {k_boot}: {(a.nrows, a.nrows, k_boot) in setup_k1}")
    solve_s, graph_s, iters = [], [], []
    for i in range(2):
        x_true = np.random.default_rng(100 + i).standard_normal(a.nrows)
        b = solver.op.mv(torch.from_numpy(x_true).to(dev))
        pair = eager_and_compiled(solver, b, "cg", RTOL, 300)
        x, info, _ = pair[1]
        solve_s.append(pair[0][2])
        graph_s.append(pair[1][2])
        iters.append(info.iters)
        true_rel = float(torch.linalg.vector_norm(b - solver.op.mv(x))
                         / torch.linalg.vector_norm(b))
        check(info.converged and info.iters <= MAX_ITERS_ELASTICITY
              and np.isfinite(true_rel) and true_rel <= 1.01 * RTOL
              and tuple(x.shape) == (a.nrows,),
              f"elasticity solve {i}: {info.iters} iterations (limit "
              f"{MAX_ITERS_ELASTICITY}), true relative residual "
              f"{true_rel:.3e} (limit {1.01 * RTOL:.3e})")
        check_same_solve(f"elasticity PCG solve {i}", pair, first=i == 0)
    del pair, x
    torch.cuda.synchronize()
    solve_counts = shape_counts()
    say_shape_counts("elasticity solves", solve_counts)
    check(sum(solve_counts["K1"].values()) > 0
          and sum(solve_counts["K2"].values()) > 0,
          "elasticity path: K1 and K2 launched in the setup and the solves")
    r = torch.from_numpy(
        np.random.default_rng(7).standard_normal(a.nrows)).to(dev)
    t_vc = median_ms(lambda: solver.apply_preconditioner(r), 20)
    t_vc_dev = median_ms(lambda: solver.apply_preconditioner(r), 20,
                         graph=True)
    say(f"elasticity V-cycle: {t_vc:.3f} ms as the solve runs it (enqueued "
        f"from Python), {t_vc_dev:.3f} ms on the device (CUDA graph "
        f"replay); PCG solves eager " + ", ".join(f"{s:.4f}" for s in solve_s)
        + " s, compiled " + ", ".join(f"{s:.4f}" for s in graph_s) + " s")

    # K1 + K2 at every (matrix, k) of the path, float64; A0 also at the
    # float32 bootstrap's k
    names = {}
    for lvl in range(h.num_levels):
        for letter, host in (("A", h.matrices), ("P", h.interpolations),
                             ("R", h.restrictions)):
            if lvl < len(host):
                names.setdefault(host[lvl].shape, (f"{letter}{lvl}",
                                                   host[lvl]))
    by_shape = {kernel: collections.Counter(setup["counts"][kernel]["by_shape"])
                + solve_counts[kernel] for kernel in ("K1", "K2")}
    ks = {}
    for kernel in ("K1", "K2"):
        for rows, cols, k in by_shape[kernel]:
            ks.setdefault((rows, cols), set()).add(k)
    cases, mats = set(), {}
    for shape, kset in sorted(ks.items()):
        name, host = names[shape]
        cases.add(f"elasticity {name}")
        mats[f"elasticity {name}"] = spmv.CappedCSR.from_csr(
            host, "cuda", torch.float64)
        kernel_cases(f"elasticity {name}",
                     {torch.float64: mats[f"elasticity {name}"]},
                     reps, results, sorted(kset))
    kernel_cases("elasticity A0",
                 {torch.float32: spmv.CappedCSR.from_csr(
                     h.matrices[0], "cuda", torch.float32)},
                 reps, results, (k_boot,))
    check({"elasticity A0", "elasticity P0", "elasticity R0",
           "elasticity A1"} <= cases,
          "sparse matrices of the elasticity path timed: "
          + ", ".join(sorted(cases)))
    k1_designs = (collections.Counter(setup["counts"]["K1"]["by_design"])
                  + solve_counts["K1 designs"])
    return dict(solver=solver, iters=iters[0], cases=cases, mats=mats,
                by_shape=by_shape, k1_designs=k1_designs,
                launches={k: sum(v.values()) for k, v in by_shape.items()},
                results=[c for c in results if c["case"] in cases])


def bootstrap_phase(f32: dict, refs: dict, results, dia_results) -> dict:
    """Phase 17: the float32 bootstrap (find_near_null in float32: K1 + K2
    at (f32, f32), K3 on the adaptive DIA fine A, the block smoother's
    inverses in float32) from the float64 setups' own draws, on the SA
    (phase 4), elasticity (phase 16) and adaptive (phase 14) problems:
    near_null seconds and each level's rows both ways; PCG with the
    float32-bootstrap hierarchy within twice the JAX package's count (SA,
    elasticity) and, on SA, the float64 count + 2 (BOOTSTRAP_EXTRA), the
    adaptive composite within 1.1 x the float64 count to 1e-12; the
    (f32, f32) launches; K1, K2
    and K3 at the bootstrap's k = 7, 11 and 63 in float32 against their
    plain versions (timed in phases 3, 16 and 14)."""
    out = {}
    for name, res in f32.items():
        ref = refs[name]
        say(setup_line(f"float32 bootstrap, {name}", res))
        say(f"float32 bootstrap, {name}: near_null {res['seconds']['near_null']:.1f}"
            f" s against float64's {ref['near_null']:.1f} s; rows float64 "
            + "; ".join(" / ".join(map(str, r)) for r in ref["rows"])
            + ", float32 " + "; ".join(" / ".join(map(str, r))
                                       for r in res["rows"]))
        say_launch_tables(f"float32 bootstrap, {name}", res["counts"])
        kernel = ref["kernel"]
        f32_launches = res["counts"][kernel]["by_dtype"].get("f32f32", 0)
        iters, rel_res = res["iters"][0], res["rel_res"][0]
        if name == "adaptive":
            limit = int(ADAPTIVE_F32_RATIO * ref["iters"])
            ok = (res["converged"] and rel_res <= ADAPTIVE_TOL
                  and iters <= limit)
            text = (f"PCG to {ADAPTIVE_TOL:.0e} with {ADAPTIVE_COMPONENTS} "
                    f"components: {iters} iterations (float64 "
                    f"{ref['iters']}; limit {limit}, 1.1 x), final rel "
                    f"residual {rel_res:.3e}")
        else:
            extra = BOOTSTRAP_EXTRA[name]
            limit = 2 * ref["jax"]
            bars = f"twice the JAX package's {ref['jax']}"
            if extra is not None:
                limit = min(limit, ref["iters"] + extra)
                bars = f"the float64 count + {extra} and " + bars
            ok = (res["converged"] and rel_res <= 1.01 * RTOL
                  and iters <= limit)
            text = (f"PCG to {RTOL:.0e}: {iters} iterations (float64 "
                    f"{ref['iters']}, {iters - ref['iters']:+d}; limit "
                    f"{limit}: {bars}), true relative residual "
                    f"{rel_res:.3e}")
        text += f"; ||E||_A {res['e_norm']:.6f}"
        check(ok and f32_launches > 0,
              f"float32 bootstrap, {name}: {text}; {kernel} at (f32, f32) "
              f"{f32_launches} launches")
        out[name] = dict(res, f32_launches=f32_launches)
    # the bootstrap's (f32, f32) shapes against their plain versions
    k7 = next(c for c in results if c["case"] == "A0" and c["k"] == 7
              and c["dtype"] == "float32")
    k11 = next(c for c in results if c["case"] == "elasticity A0"
               and c["k"] == 11 and c["dtype"] == "float32")
    k63 = next(c for c in dia_results if c["case"] == "adaptive A"
               and c["k"] == 63 and c["dtype"] == "float32")
    say(f"the float32 bootstrap's kernels at (f32, f32), held against their "
        f"plain versions above (limit {TOL['float32']:.0e}): K1 SA A0 k=7 "
        f"{k7['k1_ms'] * 1e3:.2f} us (bound {k7['k1_bound_ms'] * 1e3:.2f}, "
        f"library {k7['k1_lib_ms'] * 1e3:.2f}); K1 elasticity A0 k=11 "
        f"{k11['k1_ms'] * 1e3:.2f} us (bound {k11['k1_bound_ms'] * 1e3:.2f}, "
        f"library {k11['k1_lib_ms'] * 1e3:.2f}), its K2 "
        f"{k11['k2_ms'] * 1e3:.2f} us; K3 adaptive fine A k=63 "
        f"{k63['ms'] * 1e3:.2f} us (bound {k63['bound_ms'] * 1e3:.2f}, "
        f"library {k63['lib_ms'] * 1e3:.2f})")
    return dict(runs=out, k7=k7, k11=k11, k63=k63)


def slice11_entries(elasticity: dict, boot: dict) -> list:
    """The kernels line's entries of phases 16 and 17: K1 on the
    elasticity fine A (float64, k = 1) and K2 on its longest tail (the
    block-6 coarse A), launches over the elasticity path (its worker's
    setup and the solves); K1 + K2 at (f32, f32) on the elasticity A0 at
    the bootstrap's k = 11 (SA A0 at k = 7 beside) and K3 on the
    adaptive fine A at k = 63, launches over phase 17's three
    float32-bootstrap setups."""
    cases = [c for c in elasticity["results"] if c["dtype"] == "float64"]
    a0 = next(c for c in cases if c["case"] == "elasticity A0"
              and c["k"] == 1)
    tail = max((c for c in cases if c["k"] == 1 and c["n_tail"]),
               key=lambda c: c["n_tail"])
    runs = boot["runs"]
    f32 = {kernel: sum(r["counts"][kernel]["by_dtype"].get("f32f32", 0)
                       for r in runs.values()) for kernel in ("K1", "K2", "K3")}
    k7, k11, k63 = boot["k7"], boot["k11"], boot["k63"]
    common = dict(route="cuda", bound_by="bytes",
                  source="tpu_amg_torch/csrc/spmv.cu")
    return [
        dict(name="csr_spmv_capped_elasticity",
             replaces="tpu_amg/ops/well_pallas.py:77",
             launches=elasticity["launches"]["K1"],
             max_abs_err=max(c["err1"] for c in cases),
             ms=a0["k1_ms"], plain_ms=a0["k1_plain_ms"],
             bound_ms=a0["k1_bound_ms"], library_ms=a0["k1_lib_ms"],
             case="elasticity A0", rows=a0["shape"][0], **common),
        dict(name="coo_patch_elasticity",
             replaces="tpu_amg/ops/well_pallas.py:457",
             launches=elasticity["launches"]["K2"],
             max_abs_err=max(c["err2"] for c in cases),
             ms=tail["k2_ms"], plain_ms=tail["k2_plain_ms"],
             bound_ms=tail["k2_bound_ms"], library_ms=tail["k2_lib_ms"],
             case=tail["case"], rows=tail["shape"][0],
             tail_entries=tail["n_tail"], **common),
        dict(name="csr_spmv_capped_f32f32_bootstrap",
             replaces="tpu_amg/ops/well_pallas.py:77",
             launches=f32["K1"], max_abs_err=max(k7["err1"], k11["err1"]),
             ms=k11["k1_ms"], plain_ms=k11["k1_plain_ms"],
             bound_ms=k11["k1_bound_ms"], library_ms=k11["k1_lib_ms"],
             case="elasticity A0, k=11", k7_case="SA A0, k=7",
             k7_ms=k7["k1_ms"], k7_plain_ms=k7["k1_plain_ms"],
             k7_bound_ms=k7["k1_bound_ms"], k7_library_ms=k7["k1_lib_ms"],
             **common),
        dict(name="coo_patch_f32f32_bootstrap",
             replaces="tpu_amg/ops/well_pallas.py:457",
             launches=f32["K2"], max_abs_err=k11["err2"],
             ms=k11["k2_ms"], plain_ms=k11["k2_plain_ms"],
             bound_ms=k11["k2_bound_ms"], library_ms=k11["k2_lib_ms"],
             case="elasticity A0, k=11", **common),
        dict(name="dia_spmv_f32f32_bootstrap",
             replaces="tpu_amg/ops/dia_pallas.py:34",
             launches=f32["K3"], max_abs_err=k63["err"],
             ms=k63["ms"], plain_ms=k63["plain_ms"],
             bound_ms=k63["bound_ms"], library_ms=k63["lib_ms"],
             case="adaptive fine A, k=63", route="cuda", bound_by="bytes",
             source="tpu_amg_torch/csrc/dia.cu"),
    ]


# ---- phase 18: classical AMG and the banded coarse solve

def classical_step_seconds(log: list) -> dict:
    """The classical hierarchy's seconds by step, summed over its
    levels, from the classical module's log lines."""
    sums = collections.Counter()
    for line in log:
        if line.startswith("classical smoother partition: "):
            sums["smoother partition"] += float(line.rsplit(" ", 1)[1][:-1])
        elif line.startswith("classical level n="):
            for part in line.split("; ", 1)[1].split(", "):
                step, secs = part.rsplit(" ", 1)
                sums[step] += float(secs[:-1])
    return dict(sums)


def path_matrices(mg, h) -> dict:
    """name -> (host CSR, the float64 CappedCSR the multigrid runs, or
    None where it runs none) for every A, P and R of ``h``."""
    from tpu_amg_torch.ops import spmv

    out = {}
    for letter, host in (("A", h.matrices), ("P", h.interpolations),
                         ("R", h.restrictions)):
        for lvl, csr in enumerate(host):
            op = (getattr(mg.levels[lvl], letter.lower())
                  if lvl < len(mg.levels) else None)
            mat = getattr(op, "mat", None)
            out[f"{letter}{lvl}"] = (
                csr, mat if isinstance(mat, spmv.CappedCSR) else None)
    return out


def classical_phase(setup: dict, ckpt: str, reps: int, results,
                    dia_results) -> dict:
    """Phase 18: classical AMG on poisson2d(side) (102,400 dofs at 320)
    with the CLI's own configs (tools.amg: parse_args, configs,
    solver_config) and --smoother chebyshev: the setup of a worker
    process (its phases, each CR round, its launches), its checkpoint
    loaded here (AMGSolver.load: the auto W-cycle, μ = 2), the level
    table, W-cycle PCG to 1e-8 eager and compiled (bitwise equal, at most
    30 iterations, twice the JAX package's 15), ||E||_A, the launches by
    (rows, cols, k) and the W-cycle's times; then the two-level multigrid
    of levels 0-1, whose coarse solve goes banded past the dense cap:
    the factor's n, b, s, nb and bytes, its apply against scipy's sparse
    LU at k = 1 and 8 and timed against its bound, PCG (no more
    iterations than the W-cycle, eager and compiled bitwise equal); the
    checkpoint round trip; K1 (and K2 where a row passes K1's cap) and
    K3 (the fine A, DIA) against the plain versions at every (matrix, k)
    the path launched."""
    import scipy.sparse.linalg as spla
    import torch

    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.preconditioners.coarse import (
        DENSE_COARSE_CAP,
        BandedCholeskySolver,
    )
    from tpu_amg_torch.solver import AMGSolver
    from tpu_amg_torch.sparse.dia import DIA
    from tpu_amg_torch.tools import amg
    from tpu_amg_torch.tools.solve3d import level_table
    from tpu_amg_torch.utils.testing import approx_convergence_factor
    from tpu_amg_torch.utils.timing import hbm_bound_ms, median_ms

    side = setup["side"]
    args = amg.parse_args(classical_argv(side))
    a, _ = amg.load_problem(args)
    cfg = amg.solver_config(args)
    dev = torch.device("cuda")
    say(f"problem: poisson2d({side}): n={a.nrows} nnz={a.nnz}; the CLI's "
        f"arguments: {' '.join(classical_argv(side))}")
    sec = setup["seconds"]
    say(f"classical setup: {setup['setup_s']:.1f} s in a worker process "
        f"(near_null {sec['near_null']:.1f} s on the card and host, "
        f"hierarchy {sec['hierarchy']:.1f} s); checkpoint saved in "
        f"{setup['save_s']:.1f} s; rows "
        + " / ".join(map(str, setup["rows"])))
    for line in setup["log"]:
        say("  " + line)
    steps = classical_step_seconds(setup["log"])
    rest = sec["hierarchy"] - sum(steps.values())
    say("classical hierarchy by step over its levels, s (share of the "
        "hierarchy's): " + ", ".join(
            f"{k} {v:.1f} ({v / sec['hierarchy']:.0%})"
            for k, v in steps.items())
        + f"; the rest (the coarse near-null post-process, weights) "
        f"{rest:.1f}")
    say_launch_tables("classical setup", setup["counts"])

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    solver = AMGSolver.load(ckpt, a, cfg)
    torch.cuda.synchronize()
    h, mg = solver.hierarchy, solver.preconditioner
    say(f"classical checkpoint loaded, multigrid built: "
        f"{time.perf_counter() - t0:.1f} s; {h.num_levels} levels, mu "
        f"{mg.mu}, op complexity {h.op_complexity():.3f} (the JAX "
        f"package's {JAX_CLASSICAL['op_complexity']:.2f}), grid complexity "
        f"{h.grid_complexity():.3f}")
    for line in level_table(mg, h):
        say("  " + line)
    check(mg.mu == 2 and set(h.partition_kinds) == {"classical"}
          and h.num_levels >= 3 and isinstance(solver.op.mat, DIA),
          f"classical hierarchy: kinds {sorted(set(h.partition_kinds))}, "
          f"auto mu {mg.mu} (a W-cycle), {h.num_levels} levels; the fine "
          f"A is {type(solver.op.mat).__name__} (K3)")
    x_true = np.random.default_rng(100).standard_normal(a.nrows)
    b = solver.op.mv(torch.from_numpy(x_true).to(dev))

    def true_residual(s, x):
        return float(torch.linalg.vector_norm(b - s.op.mv(x))
                     / torch.linalg.vector_norm(b))

    pair = eager_and_compiled(solver, b, "cg", CLASSICAL_TOL, 200)
    x, info, _ = pair[1]
    w_iters, rel = info.iters, true_residual(solver, x)
    check(info.converged and w_iters <= MAX_ITERS_CLASSICAL
          and np.isfinite(rel) and rel <= 1.01 * CLASSICAL_TOL
          and tuple(x.shape) == (a.nrows,),
          f"classical W-cycle PCG to {CLASSICAL_TOL:.0e}: {w_iters} "
          f"iterations (limit {MAX_ITERS_CLASSICAL}; the JAX package's "
          f"{JAX_CLASSICAL['iters']}), true relative residual {rel:.3e} "
          f"(limit {1.01 * CLASSICAL_TOL:.3e})")
    check_same_solve("classical W-cycle PCG", pair, first=True)
    w_solve_s = (pair[0][2], pair[1][2])
    del pair, x
    t0 = time.perf_counter()
    e_norm = approx_convergence_factor(solver.op, mg)
    check(0.0 < e_norm < 1.0,
          f"classical ||E||_A (100 power steps x 5 vectors): {e_norm:.6f} "
          f"(limit (0, 1); the JAX package's {JAX_CLASSICAL['e_norm']}); "
          f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    counts = shape_counts()
    say_shape_counts("classical path (load, PCG eager and compiled, "
                     "||E||_A)", counts)
    mats = path_matrices(mg, h)
    ran = {n: m for n, (_, m) in mats.items() if m is not None}
    n_tail = sum(m.n_tail for m in ran.values())
    longest = {n: int(np.diff(csr.indptr).max()) for n, (csr, _) in
               mats.items()}
    totals = {k: sum(v.values()) for k, v in counts.items()}
    check(totals["K1"] > 0 and totals["K3"] > 0
          and (totals["K2"] > 0) == (n_tail > 0),
          f"classical path: K1 {totals['K1']}, K3 {totals['K3']} launches; "
          f"K2 {totals['K2']}, for {n_tail} tail entries past K1's cap of "
          f"{spmv.DEFAULT_CAP} over the CSR matrices the cycle runs "
          f"(longest rows: " + ", ".join(f"{k} {v}" for k, v in
                                         longest.items()) + ")")
    r = torch.from_numpy(
        np.random.default_rng(7).standard_normal(a.nrows)).to(dev)
    t_vc = median_ms(lambda: solver.apply_preconditioner(r), 20)
    t_vc_dev = median_ms(lambda: solver.apply_preconditioner(r), 20,
                         graph=True)
    say(f"classical W-cycle: {t_vc:.3f} ms as the solve runs it (enqueued "
        f"from Python), {t_vc_dev:.3f} ms on the device (CUDA graph "
        f"replay); PCG eager {w_solve_s[0]:.4f} s, compiled "
        f"{w_solve_s[1]:.4f} s (its capture included)")

    # the two-level multigrid of levels 0-1: "cholesky" goes banded
    h2 = h.truncated(2)
    coarse = h2.matrices[1]
    log = KeepLog("tpu_amg_torch.preconditioners.coarse")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    mg2 = AMGSolver._mg_config(cfg).build(h2)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    logging.getLogger("tpu_amg_torch.preconditioners.coarse").removeHandler(
        log)
    banded = mg2.coarse_solver
    kind = AMGSolver._mg_config(cfg).coarse_solver
    check(isinstance(banded, BandedCholeskySolver) and mg2.mu == 2
          and coarse.nrows > DENSE_COARSE_CAP,
          f"two-level multigrid of levels 0-1 ({h2.matrices[0].nrows} / "
          f"{coarse.nrows} rows, past the dense cap of {DENSE_COARSE_CAP}) "
          f"built in {t_build:.1f} s: its coarse solve {kind!r} is "
          f"{type(banded).__name__}; mu {mg2.mu}")
    nb, s_blk, _ = banded.inv_l_diag.shape
    say(f"banded Cholesky: n={banded.n} b={banded.bandwidth} s={s_blk} "
        f"nb={nb}; device bytes {banded.device_bytes() / 1e6:.1f} MB "
        f"(inv_l_diag and sub, float64); " + "; ".join(log.lines))
    lu = spla.splu(coarse.to_scipy().tocsc())
    rng = np.random.default_rng(11)
    errs = {}
    for k in (1, 8):
        xk = rng.standard_normal((coarse.nrows,) if k == 1
                                 else (coarse.nrows, k))
        want = lu.solve(xk)
        got = banded(torch.from_numpy(xk).to(dev)).cpu().numpy()
        errs[k] = float(np.abs(got - want).max() / np.abs(want).max())
    xb = torch.from_numpy(rng.standard_normal(coarse.nrows)).to(dev)
    band_us = median_ms(lambda: banded.mv(xb), 10, graph=True) * 1e3
    band_eager_us = median_ms(lambda: banded.mv(xb), 10) * 1e3
    # each of the two sweeps reads both stacks, far past L2
    band_bytes = 2 * banded.device_bytes()
    band_bound_us = hbm_bound_ms(band_bytes) * 1e3
    check(max(errs.values()) <= BANDED_TOL,
          f"banded apply against scipy's sparse LU solve: max rel err k=1 "
          f"{errs[1]:.3e}, k=8 {errs[8]:.3e} (limit {BANDED_TOL:.0e}); "
          f"{band_us:.2f} us on the device (CUDA graph of 10 applies, "
          f"median of 5), {band_eager_us:.2f} us enqueued; bound "
          f"{band_bound_us:.2f} us ({band_bytes} bytes: both stacks read "
          f"by each of the two sweeps, over the HBM data sheet's rate)")
    solver2 = AMGSolver(a, mg2, hierarchy=h2, config=cfg)
    pair = eager_and_compiled(solver2, b, "cg", CLASSICAL_TOL, 200)
    x, info2, _ = pair[1]
    rel = true_residual(solver2, x)
    check(info2.converged and info2.iters <= w_iters
          and rel <= 1.01 * CLASSICAL_TOL,
          f"two-level PCG (banded coarse solve) to {CLASSICAL_TOL:.0e}: "
          f"{info2.iters} iterations (limit: the W-cycle's {w_iters}), "
          f"true relative residual {rel:.3e}")
    check_same_solve("two-level PCG", pair, first=True)
    del pair, x
    torch.cuda.synchronize()
    counts2 = shape_counts()
    say_shape_counts("two-level path (build, PCG eager and compiled)",
                     counts2)
    t2_vc = median_ms(lambda: solver2.apply_preconditioner(r), 5,
                      graph=True)
    say(f"two-level cycle: {t2_vc:.3f} ms on the device (CUDA graph "
        f"replay), two banded applies in it (mu 2)")

    # the checkpoint: save, load, the same W-cycle bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        solver.save(Path(tmp) / "classical.npz")
        loaded = AMGSolver.load(Path(tmp) / "classical.npz", a, cfg)
    same = torch.equal(loaded.apply_preconditioner(r),
                       solver.apply_preconditioner(r))
    check(loaded.preconditioner.mu == 2 and same,
          f"classical checkpoint: the loaded multigrid has mu "
          f"{loaded.preconditioner.mu}; its W-cycle bitwise equal to the "
          f"original's on a seeded vector: {same}")
    del loaded

    # K1 (+ K2 where a tail exists) and K3 at every (matrix, k) of the path
    by_shape = {kernel: collections.Counter(setup["counts"][kernel]["by_shape"])
                + counts[kernel] + counts2[kernel]
                for kernel in ("K1", "K2", "K3")}
    ks = {}
    for kernel in ("K1", "K2"):
        for rows, cols, k in by_shape[kernel]:
            ks.setdefault((rows, cols), set()).add(k)
    names = {csr.shape: (n, csr, m) for n, (csr, m) in mats.items()}
    cases, timed = set(), {}
    for shape, kset in sorted(ks.items()):
        name, csr, mat = names[shape]
        cases.add(f"classical {name}")
        timed[f"classical {name}"] = (
            mat if mat is not None
            else spmv.CappedCSR.from_csr(csr, "cuda", torch.float64))
        kernel_cases(f"classical {name}",
                     {torch.float64: timed[f"classical {name}"]},
                     reps, results, sorted(kset))
    check({"classical A1", "classical P0", "classical R0"} <= cases,
          "sparse matrices of the classical path timed: "
          + ", ".join(sorted(cases)))
    # K3 runs only the fine A (DIA, 5 diagonals)
    dia_ks = {k for _, _, k in by_shape["K3"]}
    check(all((rows, cols) == a.shape for rows, cols, _ in by_shape["K3"]),
          f"classical path: K3 ran only on the fine A ({a.nrows} rows): "
          f"{sorted(by_shape['K3'])}")
    dia_kernel_cases("classical A0", solver.op.mat, a, reps, dia_results,
                     sorted(dia_ks))
    k1_designs = (collections.Counter(setup["counts"]["K1"]["by_design"])
                  + counts["K1 designs"] + counts2["K1 designs"])
    return dict(solver=solver, cases=cases, by_shape=by_shape, mats=timed,
                k1_designs=k1_designs,
                iters=w_iters, two_level_iters=info2.iters, e_norm=e_norm,
                results=[c for c in results if c["case"] in cases],
                dia_results=[c for c in dia_results
                             if c["case"] == "classical A0"])


def classical_entries(classical: dict) -> list:
    """The kernels line's entries of phase 18: K1 on the classical path
    (its worker's setup, the W-cycle and two-level runs), the first
    coarse level's A at k = 1 as the headline and every (matrix, k) it
    ran at in ``shapes`` (time, plain, bound, library, launches); K2 the
    same where the path has a tail; K3 on the fine A, k = 1 the
    headline."""
    cases = classical["results"]
    out = []
    for kernel, key, name, replaces in (
            ("K1", "k1", "csr_spmv_capped_classical",
             "tpu_amg/ops/well_pallas.py:77"),
            ("K2", "k2", "coo_patch_classical",
             "tpu_amg/ops/well_pallas.py:457")):
        launched = classical["by_shape"][kernel]
        rows = [c for c in cases if (*c["shape"], c["k"]) in launched]
        if not rows:
            continue
        head = next((c for c in rows if c["case"] == "classical A1"
                     and c["k"] == 1), rows[0])
        out.append(dict(
            name=name, route="cuda", source="tpu_amg_torch/csrc/spmv.cu",
            replaces=replaces, launches=sum(launched.values()),
            max_abs_err=max(c[f"err{key[1]}"] for c in rows),
            ms=head[f"{key}_ms"], plain_ms=head[f"{key}_plain_ms"],
            bound_ms=head[f"{key}_bound_ms"], bound_by="bytes",
            library_ms=head[f"{key}_lib_ms"], case=head["case"],
            rows=head["shape"][0],
            shapes=[dict(case=c["case"], rows=c["shape"][0],
                         cols=c["shape"][1], k=c["k"],
                         launches=launched[(*c["shape"], c["k"])],
                         max_abs_err=c[f"err{key[1]}"], ms=c[f"{key}_ms"],
                         plain_ms=c[f"{key}_plain_ms"],
                         bound_ms=c[f"{key}_bound_ms"],
                         library_ms=c[f"{key}_lib_ms"]) for c in rows]))
    # K3 on the fine A, float64 as the path runs it
    launched = classical["by_shape"]["K3"]
    rows = [c for c in classical["dia_results"] if c["dtype"] == "float64"]
    head = next(c for c in rows if c["k"] == 1)
    out.append(dict(
        name="dia_spmv_classical", route="cuda",
        source="tpu_amg_torch/csrc/dia.cu",
        replaces="tpu_amg/ops/dia_pallas.py:34",
        launches=sum(launched.values()),
        max_abs_err=max(c["err"] for c in rows),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by="bytes", library_ms=head["lib_ms"], case=head["case"],
        rows=head["n"], diagonals=head["diagonals"],
        shapes=[dict(case=c["case"], rows=c["n"], cols=c["n"], k=c["k"],
                     launches=launched[(c["n"], c["n"], c["k"])],
                     max_abs_err=c["err"], ms=c["ms"],
                     plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                     library_ms=c["lib_ms"]) for c in rows]))
    return out


# ---- phase 19: distribution on torch.distributed

DIST_RANKS = 2  # gloo ranks sharing the card (NCCL takes one rank a GPU)
DIST_RTOL_NCCL = 1e-12  # one rank: the sharded solve against the unsharded
DIST_RTOL_GLOO = 1e-10  # two ranks: the dots summed in another order
DIST_TIMEOUT = 600  # seconds the launched ranks of phase 19 may take
DIST_MAXITER = 200


def shard_record(op, pc, group, keep_x: bool = False) -> dict:
    """One path's eager PCG of A x = A x_true (seeded x_true) to RTOL,
    sharded over ``group`` against the unsharded solve on this rank
    (``parallel.dist.solve_sharded``, each solve run once untimed, then
    timed; the launches read just before and just after the timed
    sharded solve): a collective over the group; the record, with the
    launches by (rows, cols, k) and the fine level's stored entries of
    every rank, on every rank (with ``keep_x``, the sharded solve's x
    too, under "x": no JSON then)."""
    import torch
    import torch.distributed as dist

    from tpu_amg_torch.parallel.dist import solve_sharded
    from tpu_amg_torch.parallel.halo import (HaloCSR, HaloDIA, HaloELL,
                                             exchange_bytes)

    halo_forms = (HaloCSR, HaloDIA, HaloELL)

    x_true = np.random.default_rng(100).standard_normal(op.shape[0])
    b = op.mv(torch.from_numpy(x_true).cuda())
    run = solve_sharded(op, pc, b, group, rtol=RTOL, maxiter=DIST_MAXITER,
                        warmup=True)
    fine = run.fine
    halo = getattr(fine, "halo", None)
    # this rank's stored entries: a halo form's local matrix, or the
    # all-gather form's row block
    local = (fine.local if isinstance(fine, halo_forms)
             else getattr(getattr(fine, "inner", None), "local", None))
    mine = dict(launches=run.launches, nnz=getattr(local, "nnz", None))
    every = [None] * group.size
    dist.all_gather_object(every, mine, group=group.group)
    launches = {k: collections.Counter() for k in ("K1", "K2", "K3")}
    for rank in every:
        for k, by_shape in rank["launches"].items():
            launches[k].update(by_shape)
    return {
        **({"x": run.x} if keep_x else {}),
        "ranks": group.size, "backend": group.backend,
        "fine": type(fine).__name__, "fine_halo": halo,
        "levels": run.forms,
        "level_halos": [getattr(lv.a, "halo", None)
                        for lv in getattr(run.pc, "levels", ())],
        "fine_nnz_per_shard": [r["nnz"] for r in every],
        "bytes_per_spmv": (exchange_bytes(halo, group, 1, b.dtype)
                           if isinstance(fine, halo_forms) else None),
        "iters": run.info.iters, "iters_one_rank": run.info_one.iters,
        "converged": bool(run.info.converged), "x_rel_err": run.rel_err,
        "bitwise": bool(run.bitwise),
        "s_per_iteration": run.seconds / max(run.info.iters, 1),
        "s_per_iteration_one_rank": run.seconds_one / max(run.info_one.iters,
                                                          1),
        "launches": {k: sum(v.values()) for k, v in launches.items()},
        "launches_by_shape": {k: [[*key, n] for key, n in sorted(v.items())]
                              for k, v in launches.items()},
    }


def dist_rank_main(ckpt: str, side: int) -> int:
    """Phase 19 (b), one of DIST_RANKS gloo ranks on this card, started
    by :func:`distributed_phase` (``python -m chip_smoke --dist-rank
    CKPT``) after phase 2 built the kernels: phase 4's SA multigrid from
    its checkpoint and phase 7's structured one, rebuilt here, each
    solved sharded over the ranks (:func:`shard_record`); rank 0 prints
    one JSON object of both records."""
    import torch

    from tpu_amg_torch.parallel import multihost
    from tpu_amg_torch.parallel.dist import make_solver_mesh
    from tpu_amg_torch.solver import AMGSolver, SolverConfig, scalar_3d_config
    from tpu_amg_torch.structured import build_structured_multigrid
    from tpu_amg_torch.utils.problems import poisson3d, unstructured_poisson_3d

    multihost.initialize("gloo")
    try:
        group = make_solver_mesh()
        a = unstructured_poisson_3d(side)
        sa = AMGSolver.load(ckpt, a, scalar_3d_config("cuda"))
        ps = poisson3d(STRUCTURED_SIDE)
        smg = build_structured_multigrid(ps, (STRUCTURED_SIDE,) * 3,
                                         device="cuda", coarsest_dim=1000,
                                         dtype=torch.float64)
        s_op = AMGSolver(ps, smg, config=SolverConfig(device="cuda")).op
        out = {"SA": shard_record(sa.op, sa.preconditioner, group),
               "structured": shard_record(s_op, smg, group)}
        if group.index == 0:
            print(json.dumps(out), flush=True)
    finally:
        multihost.shutdown()
    return 0


def dist_launch(module: str, argv: list) -> str:
    """``module`` as DIST_RANKS gloo ranks on this card (their kernels
    built by phase 2): rank 0's output; a failed rank raises."""
    from tpu_amg_torch.parallel.multihost import launch

    return launch(module, argv, DIST_RANKS, DIST_TIMEOUT)[0]


def check_shard_record(label: str, rec: dict, limit: float,
                       kernels: tuple) -> None:
    halos = (f"fine {rec['fine']} (halo {rec['fine_halo']}), levels "
             f"{rec['levels']} (halos {rec['level_halos']})")
    check(rec["converged"] and rec["iters"] == rec["iters_one_rank"]
          and rec["x_rel_err"] <= limit
          and all(rec["launches"][k] > 0 for k in kernels),
          f"{label} sharded over {rec['ranks']} {rec['backend']} rank(s) on "
          f"the card: {halos}; fine nnz per shard "
          f"{rec['fine_nnz_per_shard']}; {rec['bytes_per_spmv']} bytes "
          f"exchanged per fine SpMV; PCG {rec['iters']} iterations (one "
          f"rank {rec['iters_one_rank']}), x rel diff {rec['x_rel_err']:.3e} "
          f"(limit {limit:.0e}), bitwise {rec['bitwise']}; "
          f"{rec['s_per_iteration'] * 1e3:.3f} ms an iteration (one rank "
          f"{rec['s_per_iteration_one_rank'] * 1e3:.3f}), each solve timed "
          f"after an untimed one; launches summed over the ranks "
          + ", ".join(f"{k} {v}" for k, v in rec["launches"].items()))
    for k, rows in rec["launches_by_shape"].items():
        if rows:
            say(f"  {label}, {rec['ranks']} rank(s): {k} launches by (rows, "
                f"cols, k): " + ", ".join(f"{tuple(r[:3])} {r[3]}"
                                          for r in rows))


def distributed_phase(solver, s_op, smg, side: int, reps: int, results,
                      dia_results, sa_containers) -> dict:
    """Phase 19, its parts one after another so that no timed solve
    shares the card: (a) the SA and structured paths sharded over NCCL
    at world size 1 in this process, and in that group phase 21 (c), the
    SA path over ELLs (``sa_containers``, :func:`sharded_containers`);
    (b) both on DIST_RANKS gloo ranks
    sharing the card (:func:`dist_rank_main`); (c)
    ``tools.dryrun_multichip`` on DIST_RANKS gloo ranks and, beside
    them, at world size 1 (NCCL) here.  Then K1 + K2 and K3 on rank 0's
    local matrices at DIST_RANKS (the SA path's A0 and R0, the
    structured A0 as HaloDIA's padded local DIA) against their plain
    versions."""
    import torch

    from tpu_amg_torch.parallel import multihost
    from tpu_amg_torch.parallel.dist import (make_solver_mesh,
                                             shard_csr_rect, shard_operator)
    from tpu_amg_torch.parallel.halo import HaloCSR, HaloDIA
    from tpu_amg_torch.shard_utils import SolverGroup
    from tpu_amg_torch.tools import dryrun_multichip
    from tpu_amg_torch.utils.timing import hbm_bound_ms

    t_phase = time.perf_counter()
    out = {}
    # (a) NCCL at world size 1, in this process, alone on the card
    multihost.initialize("nccl", world_size=1, rank=0,
                         init_method=f"tcp://localhost:"
                                     f"{multihost.free_port()}")
    try:
        group = make_solver_mesh()
        for label, op, pc, kernels in (
                ("SA", solver.op, solver.preconditioner, ("K1",)),
                ("structured", s_op, smg, ("K3",))):
            rec = shard_record(op, pc, group, keep_x=True)
            check_shard_record(label, rec, DIST_RTOL_NCCL, kernels)
            out[f"nccl {label}"] = rec
        out["nccl SA over ELLs"] = sharded_containers(
            group, sa_containers, out["nccl SA"])
    finally:
        multihost.shutdown()
    # (b) DIST_RANKS gloo ranks on the card, alone on it
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "sa.npz")
        solver.save(ckpt)
        text = dist_launch("chip_smoke", ["--dist-rank", ckpt, "--side",
                                          str(side)])
    ranks = json.loads(next(ln for ln in reversed(text.splitlines())
                            if ln.startswith("{")))
    check_shard_record("SA", ranks["SA"], DIST_RTOL_GLOO, ("K1", "K2"))
    check_shard_record("structured", ranks["structured"], DIST_RTOL_GLOO,
                       ("K3",))
    check(ranks["structured"]["fine"] == "HaloDIA"
          and ranks["structured"]["fine_halo"] > 0
          and ranks["SA"]["fine"] == "HaloCSR"
          and ranks["SA"]["fine_halo"] > 0,
          f"the fine levels at {DIST_RANKS} ranks exchange halos: SA "
          f"{ranks['SA']['fine']} halo {ranks['SA']['fine_halo']}, "
          f"structured {ranks['structured']['fine']} halo "
          f"{ranks['structured']['fine_halo']}")
    out.update({f"gloo {k}": v for k, v in ranks.items()})
    # (c) the dry run on DIST_RANKS gloo ranks, and at world size 1 here
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(dist_launch, "tpu_amg_torch.tools.dryrun_multichip",
                          ["--backend", "gloo", "--device", "cuda"])
        t0 = time.perf_counter()
        dryrun_multichip.main(["--backend", "nccl"])
        say(f"dryrun_multichip at world size 1 (NCCL): every gate passed, "
            f"{time.perf_counter() - t0:.1f} s")
        dry = job.result()
    for line in dry.splitlines():
        if line.startswith("dryrun"):
            say(f"[{DIST_RANKS} gloo ranks] {line}")
    check(dry.count(" OK") == 4,
          f"dryrun_multichip at {DIST_RANKS} gloo ranks on the card: "
          f"{dry.count(' OK')} of 4 phases passed their gates")
    # K1 + K2 and K3 per shard: rank 0's local matrices at DIST_RANKS
    shard0 = SolverGroup(None, DIST_RANKS, 0, "gloo")
    levels = solver.preconditioner.levels

    def local(op):  # a halo form's local matrix, or the all-gather form's
        return op.local if isinstance(op, (HaloCSR, HaloDIA)) else \
            op.inner.local

    a0 = local(shard_operator(levels[0].a, shard0))
    r0 = local(shard_csr_rect(levels[0].r, shard0, True, True))
    kernel_cases("D A0 shard", {torch.float64: a0}, reps, results,
                 ks=(1,))
    kernel_cases("D R0 shard", {torch.float64: r0}, reps, results, ks=(1,))
    s0 = HaloDIA.from_dia(smg.levels[0].a.mat, shard0)
    dia_kernel_cases("D S A0 shard", s0.local, dia_to_csr(s0.local), reps,
                     dia_results, ks=(1,))
    out["cases"] = {"K1": ("D A0 shard", tuple(a0.shape)),
                    "K2": ("D R0 shard", tuple(r0.shape)),
                    "K3": ("D S A0 shard", tuple(s0.local.shape))}
    # K3's bound on the shard's own rows: its n_loc rows of the
    # diagonals read, its rows and the two slabs of x read, n_loc rows of
    # y written (k = 1); the padded local DIA's 2 halo rows of zeros are
    # no part of the function (bound_in_l2 re-bounds it in L2 later)
    n_loc, halo = s0.n_loc_rows, s0.halo
    out["k3_own_rows"], out["k3_halo"] = n_loc, halo
    for rec in dia_results:
        if rec["case"] == "D S A0 shard":
            padded = rec["bytes"]
            rec["bytes"] = ((len(s0.offsets) * n_loc + (n_loc + 2 * halo)
                             + n_loc) * (8 if rec["dtype"] == "float64"
                                         else 4))
            rec["bound_ms"] = hbm_bound_ms(rec["bytes"])
            say(f"K3 D S A0 shard {rec['dtype']} k=1: bound on the shard's "
                f"{n_loc} own rows (halo {halo}): {rec['bytes'] / 1e6:.2f} "
                f"MB, {rec['bound_ms'] * 1e3:.2f} us over HBM (the padded "
                f"local DIA's {n_loc + 2 * halo} rows: {padded / 1e6:.2f} "
                f"MB)")
    say(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return out


def dist_by_shape(dist_out: dict) -> dict:
    """K1's, K2's and K3's launches by (rows, cols, k) over (b)'s sharded
    solves, summed over the ranks."""
    by_shape = {k: collections.Counter() for k in ("K1", "K2", "K3")}
    for path in ("gloo SA", "gloo structured"):
        for k, rows in dist_out[path]["launches_by_shape"].items():
            by_shape[k].update({tuple(r[:3]): r[3] for r in rows})
    return by_shape


def distributed_entries(dist_out: dict, results, dia_results) -> list:
    """The kernels line's entries of phase 19: K1, K2 and K3 on rank 0's
    local matrix at DIST_RANKS (float64, k = 1), each with the launches
    of (b)'s sharded solves at that shape, summed over the ranks."""
    by_shape = dist_by_shape(dist_out)
    out = []
    for kernel, key, name, replaces, source in (
            ("K1", "k1", "csr_spmv_capped_distributed",
             "tpu_amg/ops/well_pallas.py:77", "tpu_amg_torch/csrc/spmv.cu"),
            ("K2", "k2", "coo_patch_distributed",
             "tpu_amg/ops/well_pallas.py:457", "tpu_amg_torch/csrc/spmv.cu")):
        case, shape = dist_out["cases"][kernel]
        c = next(r for r in results if r["case"] == case
                 and r["dtype"] == "float64" and r["k"] == 1)
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=by_shape[kernel][(*shape, 1)],
            max_abs_err=c[f"err{key[1]}"],
            ms=c[f"{key}_ms"], plain_ms=c[f"{key}_plain_ms"],
            bound_ms=c[f"{key}_bound_ms"], bound_by="bytes",
            library_ms=c[f"{key}_lib_ms"], case=case,
            rows=shape[0], cols=shape[1]))
    case, shape = dist_out["cases"]["K3"]
    c = next(r for r in dia_results if r["case"] == case
             and r["dtype"] == "float64" and r["k"] == 1)
    out.append(dict(
        name="dia_spmv_distributed", route="cuda",
        source="tpu_amg_torch/csrc/dia.cu",
        replaces="tpu_amg/ops/dia_pallas.py:34",
        launches=by_shape["K3"][(*shape, 1)],
        max_abs_err=c["err"], ms=c["ms"], plain_ms=c["plain_ms"],
        bound_ms=c["bound_ms"], bound_by="bytes", library_ms=c["lib_ms"],
        case=case, rows=c["n"], own_rows=dist_out["k3_own_rows"],
        halo=dist_out["k3_halo"], diagonals=c["diagonals"]))
    return out


# ---- phase 20: the rest of M21

# (a) bench_vcycle at 64^3 float32: the JAX package took 9 PCG
# iterations there (MEASURED.md:570-573); the limit is twice that
MAX_ITERS_VCYCLE = 18
# (b) bench_unstructured at side 512 (262,144 dofs): the JAX package's
# "bf16_values" solve took 32 iterations with cd 2 and one smoothing
# step, op complexity 1.64 (MEASURED.md:404-414); the limit is twice that
UNSTRUCTURED_SIDE = 512
MAX_ITERS_UNSTRUCTURED_BF16 = 64
JAX_OP_COMPLEXITY_UNSTRUCTURED = 1.64
# (c) the real-FEM solve (VERDICT.md:242-246): tools.make_fem_fixture at
# side 512 writes 262,144 points, 2,044 of them on the boundary: 260,100
# dofs after the loader's Dirichlet elimination; rtol 1e-6, at most 200
FEM_SIDE_SOLVE = 512
FEM_MAXITER = 200
# the true relative residual's limit: 1.01 rtol, as phases 5, 14 and 18
# hold theirs; the float32 loop on the load vector adds the rounding of
# one float32 A·x, γ_m ≈ m·2^-24 times ||(|A||x|)|| / ||b|| (m the longest
# row of A): its smooth solution has ||A|| ||x|| >> ||b||
TRUE_RES_SLACK = 1.01
FEM_EPS32 = 2.0 ** -24
# (d) the breakdown's CUDA graphs: applies a graph
BREAKDOWN_REPS = 20
# the sum of components over the full apply, three runs on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md): SA 0.830 / 0.838 / 0.832, the
# composite 0.973 / 0.992 / 0.967; a halved or doubled smoother count
# (SA about 0.5 or 1.5) leaves the band
BREAKDOWN_BAND = (0.7, 1.15)
# (e) tools.aggregation on aniso2d(256), 65,536 dofs
AGGREGATION_N = 256
AGGREGATION_K = 8  # its --near-null-dim: the smoothing's SpMM width
AGGREGATION_KEYS = {"node_to_agg", "stats", "metrics", "convergence_factors"}
# (f) the CLI's --viz-out on SA aniso2d(64), 4,096 dofs
VIZ_ARGV = ["--problem", "aniso2d", "--n", "64"]
VCYCLE_KEYS = {"metric", "value", "unit", "vs_baseline", "value_bf16_values",
               "value_bf16"}
UNSTRUCTURED_KEYS = {"metric", "setup_s", "value", "unit", "vs_baseline",
                     "value_bf16_values", "solve_ms_f32",
                     "solve_ms_bf16_values", "iters_f32", "iters_bf16_values"}


def slice14_setup(kind: str, side: int, ckpt: str, workdir: str) -> dict:
    """One of phase 20's two host setups, in a setup worker: the
    problem (``unstructured_poisson_2d(side)``, or for ``kind="fem"`` the
    fixture that ``python -m tpu_amg_torch.tools.make_fem_fixture --side
    side`` writes under ``workdir``, loaded with its Dirichlet rows
    eliminated), then ``AMGSolver.setup`` with
    :func:`tpu_amg_torch.solver.unstructured_config`, its launch counts
    set to 0 just before it and read just after it, and the hierarchy
    saved to ``ckpt``."""
    import torch

    from tpu_amg_torch.solver import AMGSolver, unstructured_config
    from tpu_amg_torch.tools import bench_unstructured, bootstrap_study
    from tpu_amg_torch.utils.io import load_mfem_linear_system

    out = dict(kind=kind, side=side, ckpt=ckpt)
    t0 = time.perf_counter()
    if kind == "fem":
        name = f"fem_square_k100_s{side}"
        d = Path(workdir) / name
        subprocess.run(
            [sys.executable, "-m", "tpu_amg_torch.tools.make_fem_fixture",
             "--side", str(side), "--out", str(d)],
            check=True, capture_output=True, text=True,
            cwd=Path(__file__).resolve().parent)
        out["fixture_s"] = time.perf_counter() - t0
        a = load_mfem_linear_system(d, name).matrix
        out.update(dir=str(d), name=name)
    else:
        a = bench_unstructured.problem(side, 2)
    out.update(problem_s=time.perf_counter() - t0, n=a.nrows, nnz=a.nnz)
    torch.cuda.synchronize()
    bootstrap_study.reset_launch_counts()
    t0 = time.perf_counter()
    solver = AMGSolver.setup(a, unstructured_config("cuda"))
    torch.cuda.synchronize()
    h = solver.hierarchy
    out.update(setup_s=time.perf_counter() - t0,
               seconds=dict(solver.setup_seconds),
               counts=bootstrap_study.launch_tables(),
               rows=[m.nrows for m in h.matrices],
               op_complexity=h.op_complexity())
    solver.save(ckpt)
    return out


def slice14_setup_line(label: str, res: dict) -> str:
    return (f"{label}: n={res['n']} nnz={res['nnz']} ("
            + (f"fixture written in {res['fixture_s']:.1f} s, "
               if "fixture_s" in res else "")
            + f"problem {res['problem_s']:.1f} s); setup {res['setup_s']:.1f}"
            " s (" + ", ".join(f"{k} {v:.1f} s"
                               for k, v in res["seconds"].items())
            + f"; a worker process); rows "
            + " / ".join(map(str, res["rows"]))
            + f"; op complexity {res['op_complexity']:.3f}; setup launches "
            + ", ".join(f"{k} {sum(t['by_shape'].values())}"
                        for k, t in res["counts"].items()))


def path_kernel_cases(label, ops, reps, results, dia_results) -> list:
    """K1 + K2 (a capped CSR) or K3 (a DIA) against the plain version on
    each of ``ops`` ({name: SparseOperator}) at k = 1 in its own dtype;
    returns the case names."""
    import torch

    from tpu_amg_torch.sparse.dia import DIA

    names = []
    for name, op in ops.items():
        case = f"{label} {name}"
        mat = op.mat
        if isinstance(mat, DIA):
            dia_kernel_cases(case, mat, dia_to_csr(mat), reps, dia_results,
                             ks=(1,), dtypes=(mat.data.dtype,))
        else:
            kernel_cases(case, {mat.data.dtype: mat}, reps, results, ks=(1,))
        names.append(case)
    return names


def fem_solve(f: dict, reps: int, results, dia_results) -> dict:
    """Phase 20 (c): the real-FEM system loaded from the fixture the
    worker wrote, its hierarchy from the worker's checkpoint, PCG to
    rtol 1e-6 (at most FEM_MAXITER) on the fixture's load vector and on
    b = A x_true, each solved twice (the second timed)."""
    import torch

    from tpu_amg_torch.linop import SparseOperator
    from tpu_amg_torch.solver import AMGSolver, unstructured_config
    from tpu_amg_torch.utils.io import load_mfem_linear_system

    system = load_mfem_linear_system(f["dir"], f["name"])
    a = system.matrix
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver = AMGSolver.load(f["ckpt"], a, unstructured_config("cuda"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    dev = solver.device
    x_true = np.random.default_rng(3).standard_normal(a.nrows)
    rhs = {"load vector": torch.from_numpy(system.rhs[:, 0]).to(
               dev, torch.float32),
           "A x_true": solver.op.mv(torch.from_numpy(x_true).to(
               dev, torch.float32))}
    abs_a = a.to_scipy()
    abs_a.data = np.abs(abs_a.data)
    longest = int(a.row_nnz().max())

    def record(b, x, info, secs, float32):
        """The solve's numbers and its limit on the true residual: rtol,
        plus for a float32 loop the rounding of one float32 A·x, γ_m |A||x|
        with m the longest row (the loop's residual is float32's own)."""
        b64, x64 = b.double().cpu().numpy(), x.double().cpu().numpy()
        nb = np.linalg.norm(b64)
        rounding = (longest * FEM_EPS32 * np.linalg.norm(abs_a @ np.abs(x64))
                    / nb)
        return dict(iters=info.iters, converged=info.converged, s=secs,
                    true_res=float(np.linalg.norm(b64 - a.matvec(x64)) / nb),
                    rounding=float(rounding),
                    limit=TRUE_RES_SLACK * RTOL + (rounding if float32
                                                   else 0.0),
                    finite=bool(torch.isfinite(x).all()))

    torch.cuda.synchronize()
    reset_counts()
    solves = {}
    for label, b in rhs.items():
        x, info = solver.solve(b, rtol=RTOL, maxiter=FEM_MAXITER)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = solver.solve(b, rtol=RTOL, maxiter=FEM_MAXITER)
        torch.cuda.synchronize()
        # the load vector's solution is smooth, ||A|| ||x|| >> ||b||: its
        # float32 loop's true residual stops at A·x's float32 rounding
        solves[label] = record(b, x, info, time.perf_counter() - t0,
                               float32=label == "load vector")
    torch.cuda.synchronize()
    counts = shape_counts()
    # the same hierarchy with a float64 outer loop around the float32
    # cycle reaches rtol on the load vector
    wide = AMGSolver.load(f["ckpt"], a, unstructured_config(
        "cuda", dtype=torch.float64, cycle_precision="f32"))
    b = torch.from_numpy(system.rhs[:, 0]).to(dev, torch.float64)
    x, info = wide.solve(b, rtol=RTOL, maxiter=FEM_MAXITER)
    solves["load vector, float64 outer loop, float32 cycle"] = record(
        b, x, info, float("nan"), float32=False)
    mg = solver.preconditioner
    lvl = mg.levels[0]
    ops = {"A0": solver.op, "P0": lvl.p, "R0": lvl.r}
    if (isinstance(lvl.a, SparseOperator)
            and type(lvl.a.mat) is not type(solver.op.mat)):
        ops["A0 (cycle)"] = lvl.a  # the cycle's A0 in another format
    cases = path_kernel_cases("FEM", ops, reps, results, dia_results)
    return dict(n=a.nrows, nnz=a.nnz, load_s=load_s, solves=solves,
                solver=solver,
                counts=counts, cases=cases,
                op_complexity=solver.hierarchy.op_complexity(),
                rows=[m.nrows for m in solver.hierarchy.matrices],
                formats=[f"{type(lv.a).__name__}"
                         + (f"({type(lv.a.mat).__name__})"
                            if hasattr(lv.a, "mat")
                            and not isinstance(lv.a.mat, torch.Tensor)
                            else "") for lv in mg.levels],
                outer=type(solver.op.mat).__name__)


def composite_smoother_share(bd: dict):
    """(component, level, ms, share) of the composite's costliest
    smoother: its applies in one sweep (2·steps a cycle, times the
    member's runs) over the full composite apply."""
    best = max(
        (runs * 2 * comp["steps"] * lv["smoother_ms"], c, lv["level"])
        for c, (runs, comp) in enumerate(zip(bd["runs"], bd["components"]))
        for lv in comp["levels"])
    return best[1], best[2], best[0], best[0] / bd["full_ms"]


def sweep_smoother_ms(bd: dict) -> float:
    """Every smoother's time in one composite apply, from a breakdown:
    2·steps applies a level a member cycle, times the member's runs."""
    return sum(runs * 2 * comp["steps"] * lv["smoother_ms"]
               for runs, comp in zip(bd["runs"], bd["components"])
               for lv in comp["levels"])


def slice14_phase(jobs, reps: int, results, dia_results, sa_solver,
                  composite, workdir: str) -> dict:
    """Phase 20: (a) ``tools.bench_vcycle`` through its entry point; (b)
    ``tools.bench_unstructured`` at side 512 on the worker's checkpoint;
    (c) the real-FEM solve (:func:`fem_solve`); (d) ``tools.vcycle_breakdown``
    on phase 4's SA multigrid and phase 14's composite; (e)
    ``tools.aggregation`` on aniso2d(256); (f) the CLI's ``--viz-out``.
    Every count is set to 0 just before each of (a), (b), (c), (e), (f)
    and read just after it."""
    import contextlib
    import io

    import torch

    from tpu_amg_torch.ops import stream
    from tpu_amg_torch.sparse.dia import DIA
    from tpu_amg_torch.tools import aggregation
    from tpu_amg_torch.tools import amg as amg_cli
    from tpu_amg_torch.tools import (bench_unstructured, bench_vcycle,
                                     vcycle_breakdown)

    t_phase = time.perf_counter()
    out = {}

    # (a) bench_vcycle: the structured 64^3 float32 V-cycle, its
    # speed-of-light estimate, the bf16 modes and both PCG solves
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = bench_vcycle.run([])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, n_stream = shape_counts(), stream.stream_sum_launches
    say_shape_counts("phase 20 (a) bench_vcycle", counts)
    js, f32, b16 = (res["json"], res["solves"]["f32"],
                    res["solves"]["bf16_values"])
    check(set(js) == VCYCLE_KEYS and f32["converged"]
          and f32["iters"] <= MAX_ITERS_VCYCLE and b16["converged"]
          and sum(counts["K3"].values()) > 0 and n_stream > 0,
          f"phase 20 (a) bench_vcycle (poisson3d(64), float32, "
          f"{len(res['multigrid'].levels) + 1} levels) in {secs:.1f} s: "
          f"{json.dumps(js)}; the estimate's read rate {res['bandwidth_gbps']:.1f}"
          f" GB/s (stream_sum at 1 GiB, {n_stream} launches), estimate "
          f"{res['sol_ms']:.4f} ms; PCG f32 {f32['iters']} iterations (limit "
          f"{MAX_ITERS_VCYCLE}) {f32['s'] * 1e3:.2f} ms, bf16_values cycle "
          f"{b16['iters']} iterations {b16['s'] * 1e3:.2f} ms, both "
          "converged")
    mg = res["multigrid"]
    vc_cases = []
    for i, lvl in enumerate(mg.levels[:2]):
        if isinstance(getattr(lvl.a, "mat", None), DIA):
            name = f"vcycle A{i}"
            dia_kernel_cases(name, lvl.a.mat, dia_to_csr(lvl.a.mat), reps,
                             dia_results, ks=(1,), dtypes=(torch.float32,))
            vc_cases.append(name)
    check(len(vc_cases) == 2, f"phase 20 (a): K3 on the DIA levels "
          f"{vc_cases} (expected A0 and A1)")
    out["vcycle"] = dict(json=js, solves=res["solves"], counts=counts,
                         multigrid=mg,
                         cases=vc_cases, stream=n_stream)

    # (b) bench_unstructured at side 512 on the worker's checkpoint
    t0 = time.perf_counter()
    u = jobs["phase 20 unstructured"].get(timeout=JOB_WAIT)
    say(f"phase 20 (b): the unstructured setup's worker done "
        f"{time.perf_counter() - t0:.1f} s after (a)")
    say(slice14_setup_line(f"unstructured_poisson_2d({UNSTRUCTURED_SIDE})",
                           u))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ures = bench_unstructured.run(["--side", str(UNSTRUCTURED_SIDE),
                                   "--ckpt", u["ckpt"]])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = shape_counts()
    say_shape_counts("phase 20 (b) bench_unstructured", counts)
    uj = ures["json"]
    check(set(uj) == UNSTRUCTURED_KEYS
          and ures["solves"]["f32"]["converged"]
          and ures["solves"]["bf16_values"]["converged"]
          and uj["iters_bf16_values"] <= MAX_ITERS_UNSTRUCTURED_BF16
          and sum(counts["K1"].values()) > 0,
          f"phase 20 (b) bench_unstructured side {UNSTRUCTURED_SIDE} "
          f"({ures['a'].nrows} dofs) in {secs:.1f} s (the hierarchy loaded "
          f"from the worker's setup of {u['setup_s']:.1f} s): {json.dumps(uj)}"
          f"; bf16_values {uj['iters_bf16_values']} iterations (limit "
          f"{MAX_ITERS_UNSTRUCTURED_BF16}); op complexity "
          f"{ures['op_complexity']:.3f} (the JAX package's "
          f"{JAX_OP_COMPLEXITY_UNSTRUCTURED})")
    out["unstructured"] = dict(json=uj, setup=u, counts=counts,
                               op_complexity=ures["op_complexity"])

    # (c) the real-FEM solve at 260,100 dofs
    t0 = time.perf_counter()
    f = jobs["phase 20 fem"].get(timeout=JOB_WAIT)
    say(f"phase 20 (c): the FEM fixture and setup's worker done "
        f"{time.perf_counter() - t0:.1f} s after (b)")
    say(slice14_setup_line(f"make_fem_fixture --side {FEM_SIDE_SOLVE}", f))
    fem = fem_solve(f, reps, results, dia_results)
    say_shape_counts("phase 20 (c) the real-FEM solves", fem["counts"])
    for label, s in fem["solves"].items():
        bounded = (f" (limit {s['limit']:.3e}: rtol x {TRUE_RES_SLACK} + "
                   f"float32 A·x rounding {s['rounding']:.3e}; bounded by "
                   "float32, not converged to rtol)"
                   if s["limit"] > TRUE_RES_SLACK * RTOL else
                   f" (limit {s['limit']:.3e}; float32 A·x rounding "
                   f"{s['rounding']:.3e})")
        check(s["converged"] and s["iters"] <= FEM_MAXITER and s["finite"]
              and s["true_res"] <= s["limit"]
              and sum(fem["counts"]["K1"].values()) > 0,
              f"phase 20 (c) real FEM (P1, 100:1 checkerboard, {fem['n']} "
              f"dofs, nnz {fem['nnz']}), b = {label}: {s['iters']} PCG "
              f"iterations to {RTOL:.0e} (limit {FEM_MAXITER}), solve "
              f"{s['s']:.3f} s, true relative residual {s['true_res']:.3e}"
              f"{bounded}; setup {f['setup_s']:.1f} s (a worker; loaded "
              f"here in {fem['load_s']:.1f} s), op complexity "
              f"{fem['op_complexity']:.3f}; levels "
              + " / ".join(map(str, fem["rows"])) + f" ({', '.join(fem['formats'])}"
              f"; outer A {fem['outer']}); the synthetic "
              f"unstructured_poisson_2d({UNSTRUCTURED_SIDE}) under the same "
              f"config: {uj['iters_f32']} iterations (f32), op complexity "
              f"{ures['op_complexity']:.3f}")
    out["fem"] = dict(fem, setup=f)

    # (d) the breakdown of phase 4's SA cycle and phase 14's composite
    bds = {}
    for label, pc in (("SA", sa_solver.preconditioner),
                      ("adaptive composite", composite)):
        say(f"phase 20 (d) vcycle_breakdown of the {label}:")
        bd = vcycle_breakdown.breakdown(pc, BREAKDOWN_REPS, say=say)
        bds[label] = bd
        for c, comp in enumerate(bd.get("components", [bd])):
            say(f"  {label}" + (f" component {c}" if "components" in bd
                                else "") + ", us: " + "; ".join(
                f"level {lv['level']} ({lv['fmt']}, n {lv['n']}) A "
                f"{lv['a_ms'] * 1e3:.2f} S {lv['smoother_ms'] * 1e3:.2f} "
                f"P {lv['p_ms'] * 1e3:.2f} R {lv['r_ms'] * 1e3:.2f}"
                for lv in comp["levels"])
                + f"; coarse {comp['coarse']['ms'] * 1e3:.2f}; sum "
                f"{comp['sum_ms'] * 1e3:.2f} against the cycle "
                f"{comp['full_ms'] * 1e3:.2f}")
        ratio = bd["sum_ms"] / bd["full_ms"]
        check(BREAKDOWN_BAND[0] <= ratio <= BREAKDOWN_BAND[1],
              f"phase 20 (d) {label}: sum of components {bd['sum_ms']:.3f} "
              f"ms against the full apply {bd['full_ms']:.3f} ms (ratio "
              f"{ratio:.3f}, band {BREAKDOWN_BAND[0]}-{BREAKDOWN_BAND[1]})")
    c, lvl, ms, share = composite_smoother_share(bds["adaptive composite"])
    say(f"phase 20 (d): the composite's costliest smoother is component "
        f"{c}'s level {lvl}: {ms:.3f} ms of the sweep's "
        f"{bds['adaptive composite']['full_ms']:.3f} ms ({100 * share:.1f}%)")
    out["breakdown"] = dict(bds, top=dict(component=c, level=lvl, ms=ms,
                                          share=share))

    # (e) tools.aggregation on aniso2d(256)
    path = Path(workdir) / "aggregation.json"
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        aggregation.run(["--problem", "aniso2d", "--n", str(AGGREGATION_N),
                         "--out", str(path)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = shape_counts()
    say_shape_counts("phase 20 (e) tools.aggregation", counts)
    payload = json.loads(path.read_text())
    mods = [m["modularity"] for m in payload["metrics"]]
    for m in payload["metrics"]:
        say(f"  pass {m['iteration']}: modularity {m['modularity']:.6f}, "
            f"edge cost {m['edge_cost']:.6e}, size cost {m['size_cost']:.6e}")
    check(set(payload) == AGGREGATION_KEYS
          and len(payload["node_to_agg"]) == AGGREGATION_N ** 2
          and len(mods) > 1 and mods[-1] >= mods[0]
          and any(key[2] == AGGREGATION_K for kernel in ("K1", "K3")
                  for key in counts[kernel]),
          f"phase 20 (e) tools.aggregation aniso2d({AGGREGATION_N}) in "
          f"{secs:.1f} s: {len(mods)} logged passes, modularity "
          f"{mods[0]:.6f} -> {mods[-1]:.6f}; {payload['stats']}; the "
          f"smoothing's SpMM at k = {AGGREGATION_K}: K1 at k = "
          f"{sorted({key[2] for key in counts['K1']})}, K3 (a DIA A) at k = "
          f"{sorted({key[2] for key in counts['K3']})}")
    out["aggregation"] = dict(counts=counts, mods=mods)

    # (f) one CLI run with --viz-out
    path = Path(workdir) / "hierarchy_viz.json"
    err = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as cli_out, \
            contextlib.redirect_stderr(err):
        amg_cli.main([*VIZ_ARGV, "--viz-out", str(path)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = shape_counts()
    num_levels = int(err.getvalue().split("Hierarchy(levels=")[1]
                     .split(",")[0])
    viz = json.loads(path.read_text())
    lens = [(len(lv["node_to_agg"]), lv["dims"][0]) for lv in viz["levels"]]
    check(len(viz["levels"]) == num_levels - 1
          and all(n == d for n, d in lens)
          and sum(counts["K1"].values()) > 0,
          f"phase 20 (f) tools.amg {' '.join(VIZ_ARGV)} --viz-out in "
          f"{secs:.1f} s: final line "
          f"{cli_out.getvalue().strip().splitlines()[-1]!r}; {num_levels} "
          f"levels, {len(viz['levels'])} level entries, node_to_agg "
          f"lengths {[n for n, _ in lens]}")
    out["viz"] = dict(counts=counts)
    say(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return out


def slice14_entries(p20: dict, results, dia_results) -> list:
    """The kernels line's entries of phase 20: K1 and K2 (float32) on the
    real-FEM path's CSR operators, A0 (the outer operator) the headline,
    every (matrix, k) in ``shapes``; K3 (float32) on bench_vcycle's A0
    and A1, and on the real-FEM cycle's A0 where it is DIA.  Launches:
    the path's (the real-FEM solves; bench_vcycle's run), and over every
    path of phase 20 in ``launches_phase20``."""
    total = collections.Counter()
    for part in ("vcycle", "unstructured", "fem", "aggregation", "viz"):
        for kernel, by_shape in p20[part]["counts"].items():
            total[kernel] += sum(by_shape.values())
    fem = p20["fem"]
    out = []

    def entry(name, source, replaces, kernel, rows, key, launched, extra):
        head = rows[0]
        if key == "k3":
            def shape(c):
                return (c["n"], c["n"], c["k"])
            fields = dict(ms="ms", plain_ms="plain_ms", bound_ms="bound_ms",
                          library_ms="lib_ms", err="err")
        else:
            def shape(c):
                return (*c["shape"], c["k"])
            fields = dict(ms=f"{key}_ms", plain_ms=f"{key}_plain_ms",
                          bound_ms=f"{key}_bound_ms",
                          library_ms=f"{key}_lib_ms", err=f"err{key[1]}")
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(launched.values()),
            launches_phase20=total[kernel],
            max_abs_err=max(c[fields["err"]] for c in rows),
            ms=head[fields["ms"]], plain_ms=head[fields["plain_ms"]],
            bound_ms=head[fields["bound_ms"]], bound_by="bytes",
            library_ms=head[fields["library_ms"]], case=head["case"],
            dtype="float32",
            shapes=[dict(case=c["case"], shape=list(shape(c)),
                         launches=launched.get(shape(c), 0),
                         max_abs_err=c[fields["err"]],
                         ms=c[fields["ms"]], plain_ms=c[fields["plain_ms"]],
                         bound_ms=c[fields["bound_ms"]],
                         library_ms=c[fields["library_ms"]]) for c in rows],
            **extra)

    csr = [c for c in results if c["case"] in fem["cases"]]
    for kernel, key, name, replaces in (
            ("K1", "k1", "csr_spmv_capped_fem_f32",
             "tpu_amg/ops/well_pallas.py:77"),
            ("K2", "k2", "coo_patch_fem_f32",
             "tpu_amg/ops/well_pallas.py:457")):
        rows = [c for c in csr if kernel == "K1" or c["n_tail"]]
        if rows:
            out.append(entry(name, "tpu_amg_torch/csrc/spmv.cu", replaces,
                             kernel, rows, key, fem["counts"][kernel],
                             dict(rows=rows[0]["shape"][0])))
    fem_dia = [c for c in dia_results if c["case"] in fem["cases"]]
    if fem_dia:
        out.append(entry("dia_spmv_fem_f32", "tpu_amg_torch/csrc/dia.cu",
                         "tpu_amg/ops/dia_pallas.py:34", "K3", fem_dia, "k3",
                         fem["counts"]["K3"], dict(rows=fem_dia[0]["n"])))
    vc = p20["vcycle"]
    vc_rows = [c for c in dia_results if c["case"] in vc["cases"]]
    out.append(entry("dia_spmv_vcycle_f32", "tpu_amg_torch/csrc/dia.cu",
                     "tpu_amg/ops/dia_pallas.py:34", "K3", vc_rows, "k3",
                     vc["counts"]["K3"],
                     dict(rows=vc_rows[0]["n"],
                          diagonals=vc_rows[0]["diagonals"])))
    return out


# (value, vector) dtype names of the mixed pairs phase 15 runs
PRECISION_PAIRS = (("bfloat16", "float64"), ("bfloat16", "float32"),
                   ("float32", "float64"))
PRECISION_MODES = (None, "f32", "bf16_values", "bf16")
ADAPTIVE_MODES = ("bf16_values", "f32")
PRECISION_TRUE_RES = 1e-5  # true residual / ||b|| of a cast cycle's solve
# the adaptive composite's cast solves stop here.  In "bf16_values"
# neither package's composite converges within the uncast count + 3 on
# this problem: at 1,024 dofs the bf16 rounding of A is indefinite, the
# JAX package's own cycle stalls and the port's needs 69 iterations
# against f64's 19 (tests/test_torch_precision.py); at 262,144 dofs the
# port's stalls
ADAPTIVE_CAST_MAXITER = 100
# card against CPU on the small SA input: "bf16_values" sums in f64 on
# both; "bf16" rounds the island's f32 sums to bf16 in another order
SMALL_TOL = {"bf16_values": 1e-10, "bf16": 5e-2}


def pair_name(v: str, t: str) -> str:
    short = {"float64": "f64", "float32": "f32", "bfloat16": "bf16"}
    return short[v] + short[t]


def pair_bound(nbytes, l2) -> float:
    """The bound of ``nbytes`` on this card: over the L2 read rate of
    phase 11 where they fit in L2, else over the HBM data sheet."""
    import torch

    from tpu_amg_torch.tools import dmabench

    return dmabench.bound(nbytes, torch.device("cuda"), l2)["bound_ms"]


def mixed_csr_cases(name, csr, reps, l2, out, ks=(1, 8)):
    """K1 and K2 at each mixed pair on one matrix: against their plain
    versions (the values widened first) at T's tolerance, two calls
    bitwise equal; device times beside the same matrix's (T, T) kernels
    (its values widened), the library's call on the widened values and
    the bound of the bytes with V-sized values."""
    import torch

    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.precision import cast_operator
    from tpu_amg_torch.utils.timing import median_ms

    for vname, tname in PRECISION_PAIRS:
        v, t = getattr(torch, vname), getattr(torch, tname)
        mat = spmv.CappedCSR.from_csr(csr, "cuda", v)
        wide = cast_operator(mat, t)  # the same values, widened
        lib1 = torch_csr(wide.indptr, wide.indices, wide.data, wide.shape)
        lib2 = tail_csr(wide) if wide.n_tail else None
        vsz, tsz = mat.data.element_size(), wide.data.element_size()
        for k in ks:
            g = torch.Generator(device="cuda").manual_seed(k)
            shape = (mat.shape[1],) if k == 1 else (mat.shape[1], k)
            x = torch.randn(shape, generator=g, device="cuda", dtype=t)
            y1, y1b = spmv.csr_spmv_capped(mat, x), spmv.csr_spmv_capped(mat, x)
            p1 = spmv.plain_csr_spmv_capped(mat, x)
            y2, y2b, p2 = (torch.zeros_like(y1) for _ in range(3))
            spmv.coo_patch(mat, x, y2)
            spmv.coo_patch(mat, x, y2b)
            spmv.plain_coo_patch(mat, x, p2)
            torch.cuda.synchronize()
            same = torch.equal(y1, y1b) and torch.equal(y2, y2b)
            p = p1 + p2
            scale = max(float(p.abs().max()), 1e-300)
            rel = float((y1 + y2 - p).abs().max()) / scale
            rec = dict(case=name, pair=pair_name(vname, tname), k=k,
                       shape=tuple(mat.shape), err1=float((y1 - p1).abs().max()),
                       err2=float((y2 - p2).abs().max()), n_tail=mat.n_tail)
            rec["k1_ms"] = median_ms(lambda: spmv.csr_spmv_capped(mat, x),
                                     reps, graph=True)
            plain_reps = reps if k == 1 else min(reps, PLAIN_REPS)
            rec["k1_plain_ms"] = median_ms(
                lambda: spmv.plain_csr_spmv_capped(mat, x), plain_reps,
                graph=True)
            rec["k1_tt_ms"] = median_ms(lambda: spmv.csr_spmv_capped(wide, x),
                                        reps, graph=True)
            rec["k1_lib_ms"] = median_ms(lambda: lib1 @ x, reps, graph=True)
            rec["k1_bound_ms"] = pair_bound(spmv.k1_bytes(mat, k, t), l2)
            text = (f"K1 {rec['k1_ms'] * 1e3:.2f} us ((T, T) "
                    f"{rec['k1_tt_ms'] * 1e3:.2f}, plain "
                    f"{rec['k1_plain_ms'] * 1e3:.2f}, library on the widened "
                    f"values {rec['k1_lib_ms'] * 1e3:.2f}, bound "
                    f"{rec['k1_bound_ms'] * 1e3:.2f})")
            for key in ("k2_ms", "k2_plain_ms", "k2_tt_ms", "k2_lib_ms",
                        "k2_bound_ms"):
                rec[key] = None
            if mat.n_tail:
                yz = torch.zeros_like(y1)
                rec["k2_ms"] = median_ms(lambda: spmv.coo_patch(mat, x, yz),
                                         reps, graph=True)
                rec["k2_plain_ms"] = median_ms(
                    lambda: spmv.plain_coo_patch(mat, x, yz), plain_reps,
                    graph=True)
                rec["k2_tt_ms"] = median_ms(
                    lambda: spmv.coo_patch(wide, x, yz), reps, graph=True)
                rec["k2_lib_ms"] = median_ms(lambda: lib2 @ x, reps,
                                             graph=True)
                cols = int(torch.unique(mat.tail_cols).numel())
                rows = mat.n_tail_rows
                rec["k2_bound_ms"] = pair_bound(
                    mat.n_tail * (4 + vsz) + 4 * (2 * rows + 1)
                    + (cols + 2 * rows) * k * tsz, l2)
                text += (f"; K2 {rec['k2_ms'] * 1e3:.2f} us ((T, T) "
                         f"{rec['k2_tt_ms'] * 1e3:.2f}, plain "
                         f"{rec['k2_plain_ms'] * 1e3:.2f}, library "
                         f"{rec['k2_lib_ms'] * 1e3:.2f}, bound "
                         f"{rec['k2_bound_ms'] * 1e3:.2f})")
            designs_ok = True
            if k > 1:
                designs_ok, more, fields = design_case(
                    mat, x, y1, min(reps, DESIGN_REPS), TOL[tname])
                text += more
                rec.update(fields)
            check(rel <= TOL[tname] and same and designs_ok,
                  f"mixed K1+K2 {name} ({vname}, {tname}) k={k}: shape "
                  f"{mat.shape} nnz {mat.nnz} tail {mat.n_tail}: max rel err "
                  f"{rel:.3e} (limit {TOL[tname]:.0e}), two calls bitwise "
                  f"equal: {same}; " + text)
            out.append(rec)


def mixed_dia_cases(name, dia64, reps, l2, out, ks=(1, 8, 64)):
    """K3 at each mixed pair on one DIA matrix: against its plain version
    at T's tolerance, bitwise against its first design and across two
    calls, and the band tiles bitwise equal to the first design; device
    times of K3 and its first design (in turns, A B B A) beside the
    (T, T) kernel on the widened diagonals, the library's call on the
    same CSR (widened values) and the bound with V-sized diagonals;
    below k = TILED_MIN_K also the band tiles."""
    import torch

    from tpu_amg_torch.ops import dia as dia_ops
    from tpu_amg_torch.utils.timing import alternating_ms, median_ms

    n, n_diags = dia64.shape[0], len(dia64.offsets)
    # the CSR of the stored nonzeros: where each entry lies in data
    offsets = np.asarray(dia64.offsets, dtype=np.int64)
    rows = np.tile(np.arange(n, dtype=np.int64), n_diags)
    cols = rows + np.repeat(offsets, n)
    keep = np.flatnonzero((cols >= 0) & (cols < n)
                          & (dia64.data.cpu().numpy().ravel() != 0))
    keep = keep[np.lexsort((cols[keep], rows[keep]))]
    indptr = torch.from_numpy(np.r_[0, np.cumsum(np.bincount(
        rows[keep], minlength=n))]).cuda()
    indices = torch.from_numpy(cols[keep]).cuda()
    where = torch.from_numpy(keep).cuda()
    for vname, tname in PRECISION_PAIRS:
        v, t = getattr(torch, vname), getattr(torch, tname)
        mat = dia64.astype(v)
        wide = mat.astype(t)
        lib = torch_csr(indptr, indices, wide.data.reshape(-1)[where],
                        (n, n))
        for k in ks:
            g = torch.Generator(device="cuda").manual_seed(k)
            x = torch.randn((n,) if k == 1 else (n, k), generator=g,
                            device="cuda", dtype=t)
            y, again = dia_ops.dia_spmv(mat, x), dia_ops.dia_spmv(mat, x)
            first = dia_ops.launch_first_design(mat, x)
            tiles = dia_ops.launch_band_tiles(mat, x)
            p = dia_ops.plain_dia_spmv(mat, x)
            torch.cuda.synchronize()
            same = (torch.equal(y, again) and torch.equal(y, first)
                    and torch.equal(tiles, first))
            scale = max(float(p.abs().max()), 1e-300)
            err = float((y - p).abs().max())
            rec = dict(case=name, pair=pair_name(vname, tname), k=k, n=n,
                       err=err, diagonals=n_diags)
            rec["ms"], rec["first_ms"] = alternating_ms(
                [lambda: dia_ops.dia_spmv(mat, x),
                 lambda: dia_ops.launch_first_design(mat, x)], reps)
            rec["plain_ms"] = median_ms(lambda: dia_ops.plain_dia_spmv(mat, x),
                                        reps, graph=True)
            rec["tt_ms"] = median_ms(lambda: dia_ops.dia_spmv(wide, x), reps,
                                     graph=True)
            rec["lib_ms"] = median_ms(lambda: lib @ x, reps, graph=True)
            if k < dia_ops.TILED_MIN_K:
                rec["tiled_ms"] = median_ms(
                    lambda: dia_ops.launch_band_tiles(mat, x), reps,
                    graph=True)
            rec["bound_ms"] = pair_bound(
                n_diags * n * mat.data.element_size()
                + 2 * n * k * x.element_size(), l2)
            check(err / scale <= TOL[tname] and same,
                  f"mixed K3 {name} ({vname}, {tname}) k={k}: n {n}, "
                  f"{n_diags} diagonals, nnz {len(keep)}: max rel err "
                  f"{err / scale:.3e} (limit {TOL[tname]:.0e}); bitwise "
                  f"equal to the first design and to a second call, the "
                  f"band tiles to the first design: {same}; K3 "
                  f"{rec['ms'] * 1e3:.2f} us (first design "
                  f"{rec['first_ms'] * 1e3:.2f}, "
                  + (f"band tiles {rec['tiled_ms'] * 1e3:.2f}, "
                     if "tiled_ms" in rec else "")
                  + f"(T, T) "
                  f"{rec['tt_ms'] * 1e3:.2f}, plain "
                  f"{rec['plain_ms'] * 1e3:.2f}, library on the widened "
                  f"values {rec['lib_ms'] * 1e3:.2f}, bound "
                  f"{rec['bound_ms'] * 1e3:.2f})")
            out.append(rec)


def dtype_counts() -> dict:
    """K1's, K2's and K3's launches by (value, vector) dtype names since
    the last reset."""
    from tpu_amg_torch.ops import dia, spmv

    def named(counter):
        return {pair_name(str(v)[6:], str(t)[6:]): n
                for (v, t), n in counter.items()}

    return {"K1": named(spmv.csr_spmv_launches_by_dtype),
            "K2": named(spmv.coo_patch_launches_by_dtype),
            "K3": named(dia.dia_spmv_launches_by_dtype)}


def add_counts(total: dict, counts: dict) -> None:
    for kernel, by_pair in counts.items():
        for pair, n in by_pair.items():
            total.setdefault(kernel, {}).setdefault(pair, 0)
            total[kernel][pair] += n


def count_launches(totals: dict) -> dict:
    """The launches since the last reset by (value, vector) dtype names
    (:func:`dtype_counts`), added to ``totals``; K3's also by (rows,
    cols, k, pair), added to ``totals["K3 by shape"]``."""
    from tpu_amg_torch.ops import dia

    counts = dtype_counts()
    add_counts(totals, counts)
    totals.setdefault("K3 by shape", collections.Counter()).update(
        {(r, c, k, pair_name(str(v)[6:], str(t)[6:])): n
         for (r, c, k, v, t), n
         in dia.dia_spmv_launches_by_shape_dtype.items()})
    return counts


def cycle_shares(pc, vdtype, t_cycle_ms) -> str:
    """The share of a V-cycle's device time (``t_cycle_ms``) that its
    dense levels and coarse solve take, and its smoothers', from one
    apply of each part (CUDA graph replays) times its count in a cycle:
    a level applies A 2 s + 1 times and its smoother 2 s times (s the
    smoothing steps), the coarsest level its coarse solve once."""
    import torch

    from tpu_amg_torch.linop import DenseOperator
    from tpu_amg_torch.utils.timing import median_ms

    mg = getattr(pc, "inner", pc)
    steps = mg.smoothing_steps
    gen = torch.Generator().manual_seed(5)

    def vec(n):
        return torch.randn(n, generator=gen).to("cuda", vdtype)

    v = vec(mg.coarse_solver.shape[0])
    t_coarse = median_ms(lambda: mg.coarse_solver.mv(v), 20, graph=True)
    t_dense, t_smooth = t_coarse, 0.0
    for level in mg.levels:
        v = vec(level.a.shape[0])
        t_s = median_ms(lambda lv=level, v=v: lv.smoother.mv(v), 20,
                        graph=True)
        t_smooth += 2 * steps * t_s
        if isinstance(level.a, DenseOperator):
            t_a = median_ms(lambda lv=level, v=v: lv.a.mv(v), 20, graph=True)
            t_dense += (2 * steps + 1) * t_a + 2 * steps * t_s
    return (f"dense levels and coarse solve {t_dense * 1e3:.1f} us "
            f"({t_dense / t_cycle_ms:.1%} of the cycle; the coarse solve "
            f"alone {t_coarse * 1e3:.1f} us, {t_coarse / t_cycle_ms:.1%}), "
            f"every level's smoother (the dense levels' too) "
            f"{t_smooth * 1e3:.1f} us ({t_smooth / t_cycle_ms:.1%})")


def precision_path(label, solver, max_iters, totals) -> dict:
    """One path's modes: each cycle cast by cast_preconditioner, 3 PCG
    solves of A x = A x_true to rtol 1e-6 eager and compiled (the same
    iterations and, bitwise, x), iterations <= the uncast cycle's + 3,
    true residual <= PRECISION_TRUE_RES ||b||, launches by (V, T) (bf16
    values launched in the bf16 modes), the V-cycle enqueued and on the
    device, and its dense and smoother shares."""
    import torch

    from tpu_amg_torch.precision import cast_preconditioner
    from tpu_amg_torch.solver import AMGSolver
    from tpu_amg_torch.utils.timing import median_ms

    op = solver.op
    n = op.shape[0]
    rhs = []
    for i in range(3):
        x_true = np.random.default_rng(300 + i).standard_normal(n)
        rhs.append(op.mv(torch.from_numpy(x_true).cuda()))
    base, out = None, {}
    for mode in PRECISION_MODES:
        pc = cast_preconditioner(solver.preconditioner, mode)
        cast = AMGSolver(solver.matrix, pc, hierarchy=solver.hierarchy,
                         config=solver.config, op=op)
        torch.cuda.synchronize()
        reset_counts()
        iters = []
        for i, b in enumerate(rhs):
            pair = eager_and_compiled(cast, b, "cg", RTOL, 200)
            x, info, _ = pair[1]
            true_rel = float(torch.linalg.vector_norm(b - op.mv(x))
                             / torch.linalg.vector_norm(b))
            limit = max_iters if base is None else base[i] + 3
            check(info.converged and info.iters <= limit
                  and true_rel <= PRECISION_TRUE_RES,
                  f"{label} cycle_precision={mode} solve {i}: {info.iters} "
                  f"iterations (limit {limit}), true relative residual "
                  f"{true_rel:.3e} (limit {PRECISION_TRUE_RES:.0e})")
            check_same_solve(f"{label} {mode} PCG solve {i}", pair,
                             first=i == 0)
            iters.append(info.iters)
        torch.cuda.synchronize()
        counts = count_launches(totals)
        bf16 = sum(n for by_pair in counts.values()
                   for pair, n in by_pair.items() if pair.startswith("bf16"))
        check(mode not in ("bf16_values", "bf16") or bf16 > 0,
              f"{label} {mode}: launches by (values, vectors): "
              + "; ".join(f"{k} " + ", ".join(f"{p} {c}" for p, c in
                                              sorted(v.items()))
                          for k, v in counts.items() if v))
        base = base or iters
        vdt = torch.bfloat16 if mode == "bf16" else torch.float64
        r = torch.from_numpy(np.random.default_rng(7).standard_normal(n)).cuda()
        t_vc = median_ms(lambda: pc.mv(r), 20)
        t_dev = median_ms(lambda: pc.mv(r), 20, graph=True)
        say(f"{label} {mode} V-cycle: {t_vc:.3f} ms enqueued, {t_dev:.3f} "
            f"ms on the device; PCG iterations {iters}; "
            + cycle_shares(pc, vdt, t_dev))
        out[str(mode)] = dict(iters=iters, vcycle_ms=t_vc, vcycle_dev_ms=t_dev)
    return out


def adaptive_precision(solver, small, totals) -> dict:
    """The adaptive composite in "bf16_values" and "f32" beside its
    uncast cycle: one eager PCG solve of A x = A x_true to 1e-6 each (at
    most ADAPTIVE_CAST_MAXITER iterations), ms an iteration, the
    composite V-cycle on the device and its block smoothers' share (both
    from :func:`tpu_amg_torch.tools.vcycle_breakdown.breakdown`).
    "f32" must converge within the uncast solve's iterations + 3.
    "bf16_values" does not on this problem, in either package
    (ADAPTIVE_CAST_MAXITER): its solve must end with a finite iterate
    and is reported as it ends.  Then ``small`` (phase 14's small
    composite on the card and its CPU twin) cast to both modes: the
    cycle card against CPU at 1e-10, mv and mm."""
    import torch

    from tpu_amg_torch.precision import cast_preconditioner
    from tpu_amg_torch.solvers import cg
    from tpu_amg_torch.tools import vcycle_breakdown

    op, n = solver.op, solver.op.shape[0]
    b = op.mv(torch.from_numpy(
        np.random.default_rng(200).standard_normal(n)).cuda())
    base, out = None, {}
    for mode in (None,) + ADAPTIVE_MODES:
        pc = cast_preconditioner(solver.preconditioner, mode)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        x, info = cg(op, b, pc, rtol=RTOL,
                     maxiter=500 if mode is None else ADAPTIVE_CAST_MAXITER)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        count_launches(totals)
        true_rel = float(torch.linalg.vector_norm(b - op.mv(x))
                         / torch.linalg.vector_norm(b))
        limit = 500 if base is None else base + 3
        # the composite apply and its block smoothers' share, both from
        # one tools.vcycle_breakdown attribution
        bd = vcycle_breakdown.breakdown(pc, 10, say=lambda msg: None)
        t_dev, t_s = bd["full_ms"], sweep_smoother_ms(bd)
        inv_mb = sum(bk.inv_blocks.numel() * bk.inv_blocks.element_size()
                     for comp in pc.components for level in comp.levels
                     for bk in getattr(level.smoother, "buckets", ())) / 1e6
        ok = (bool(torch.isfinite(x).all()) if mode == "bf16_values"
              else info.converged and info.iters <= limit
              and true_rel <= PRECISION_TRUE_RES)
        held = ("a finite iterate; the limit is not held here"
                if mode == "bf16_values" else f"limit {limit}")
        check(ok, f"adaptive cycle_precision={mode}: eager PCG {info.iters} "
              f"iterations ({held}), converged {info.converged}, "
              f"true relative residual "
              f"{true_rel:.3e}, {t / max(info.iters, 1) * 1e3:.2f} ms an "
              f"iteration; composite V-cycle {t_dev:.3f} ms on the device, "
              f"block smoothers {t_s:.3f} ms of it ({t_s / t_dev:.1%}; "
              f"{inv_mb:.1f} MB of block inverses)")
        base = base if base is not None else info.iters
        out[str(mode)] = dict(iters=info.iters, converged=info.converged,
                              true_rel=true_rel, ms_per_iter=t / info.iters,
                              vcycle_dev_ms=t_dev, smoother_ms=t_s)

    s_gpu, twin = small
    rng = np.random.default_rng(12)
    for mode in ADAPTIVE_MODES:
        pg = cast_preconditioner(s_gpu.preconditioner, mode)
        pc = cast_preconditioner(twin, mode)
        diffs = []
        for shape in ((twin.shape[0],), (twin.shape[0], 5)):
            v = torch.from_numpy(rng.standard_normal(shape))
            zg, zc = pg(v.cuda()).cpu(), pc(v)
            diffs.append(float((zg - zc).abs().max() / zc.abs().max()))
        check(max(diffs) <= 1e-10,
              f"small composite cycle_precision={mode}: apply rel diff "
              f"card against CPU {diffs[0]:.2e} (mv), {diffs[1]:.2e} (mm, "
              f"k=5) (limit 1e-10)")
    return out


def precision_phase(reps, l2, paths) -> dict:
    """Phase 15: mixed-precision cycles (tpu_amg_torch.precision).  The
    kernels at (bf16, f64), (bf16, f32) and (f32, f64) on the main
    paths' matrices; then the SA (phase 4), structured (phase 7) and
    adaptive (phase 14) hierarchies cast in each mode and solved; the
    small SA input card against CPU; the CLI's --precision bf16_values.
    Returns the kernels' records and the launches by (values, vectors)
    over the paths' runs."""
    import torch

    from tpu_amg_torch.ops import dia as dia_ops
    from tpu_amg_torch.precision import cast_preconditioner
    from tpu_amg_torch.solvers import cg

    t_phase = time.perf_counter()
    csr_recs, dia_recs = [], []
    h = paths["sa"].hierarchy
    for name, csr in ((K1_HEADLINE, paths["head"]), ("A0", h.matrices[0]),
                      ("P0", h.interpolations[0]),
                      ("R0", h.restrictions[0]), ("A1", h.matrices[1])):
        mixed_csr_cases(name, csr, reps, l2, csr_recs)
    smg = paths["structured"].preconditioner
    for name, dia in (("S A0", smg.levels[0].a.mat),
                      ("S A1", smg.levels[1].a.mat),
                      ("adaptive A", paths["adaptive"].op.mat)):
        mixed_dia_cases(name, dia, reps, l2, dia_recs)
    t_kernels = time.perf_counter() - t_phase

    totals = {}
    sa = precision_path("SA", paths["sa"], MAX_ITERS, totals)
    st = precision_path("structured", paths["structured"],
                        MAX_ITERS_STRUCTURED, totals)
    ad = adaptive_precision(paths["adaptive"], paths["adaptive_small"],
                            totals)

    # the small SA input: the card against the CPU on one hierarchy
    s_gpu, mg_cpu, op_cpu = paths["small"]
    b_np = np.random.default_rng(3).standard_normal(s_gpu.op.shape[0])
    for mode, tol in SMALL_TOL.items():
        pg = cast_preconditioner(s_gpu.preconditioner, mode)
        pcpu = cast_preconditioner(mg_cpu, mode)
        zg = pg.mv(torch.from_numpy(b_np).cuda()).cpu()
        zc = pcpu.mv(torch.from_numpy(b_np))
        dz = float((zg - zc).norm() / zc.norm())
        _, ig = cg(s_gpu.op, torch.from_numpy(b_np).cuda(), pg, rtol=RTOL)
        _, ic = cg(op_cpu, torch.from_numpy(b_np), pcpu, rtol=RTOL)
        check(dz <= tol and ig.converged and abs(ig.iters - ic.iters)
              <= (0 if mode == "bf16_values" else 2),
              f"small SA input {mode}: V-cycle card against CPU rel diff "
              f"{dz:.2e} (limit {tol:.0e}); PCG card {ig.iters} / CPU "
              f"{ic.iters} iterations")

    # the CLI with --precision
    torch.cuda.synchronize()
    reset_counts()
    argv = ["--structured", "--problem", "poisson3d", "--n",
            str(STRUCTURED_SIDE), "--tol", "1e-6", "--precision",
            "bf16_values"]
    line, secs, _ = run_cli("tpu_amg_torch.tools.amg", argv)
    torch.cuda.synchronize()
    counts = count_launches(totals)
    cg_iters = int(line.split()[0])
    check(cg_iters <= MAX_ITERS_STRUCTURED
          and counts["K3"].get("bf16f64", 0) > 0,
          f"CLI {' '.join(argv)}: final line {line!r} ({secs:.1f} s), "
          f"cg_iters {cg_iters} (limit {MAX_ITERS_STRUCTURED}); K3 at "
          f"(bf16, f64) {counts['K3'].get('bf16f64', 0)} launches")

    missing = [f"{k} {pair_name(v, t)}" for k in ("K1", "K2", "K3")
               for v, t in PRECISION_PAIRS
               if totals.get(k, {}).get(pair_name(v, t), 0) == 0]
    check(not missing,
          "phase 15 launches by (values, vectors) over its paths: "
          + "; ".join(f"{k} " + ", ".join(f"{p} {c}" for p, c in
                                          sorted(v.items()))
                      for k, v in totals.items() if k != "K3 by shape")
          + (f"; never launched: {missing}" if missing else ""))
    say(f"phase 15: {time.perf_counter() - t_phase:.1f} s "
        f"(kernel cases {t_kernels:.1f} s)")
    return dict(csr=csr_recs, dia=dia_recs, totals=totals, sa=sa,
                structured=st, adaptive=ad)


def precision_entries(precision) -> list:
    """The kernels line's entries of phase 15: one a kernel and mixed
    pair, read on the paths' largest matrix at k = 1 (K1 on the
    262,144-row A0, K2 on the SA path's R0 tail, K3 on the structured
    1,000,000-row A0); launches over phase 15's mode runs; library: the
    (T, T) call on the widened values (no library call takes a mixed
    pair)."""
    entries = []
    for v, t in PRECISION_PAIRS:
        pair = pair_name(v, t)
        csr = [c for c in precision["csr"] if c["pair"] == pair]
        dia = [c for c in precision["dia"] if c["pair"] == pair]
        k1 = next(c for c in csr if c["case"] == K1_HEADLINE and c["k"] == 1)
        k2 = next(c for c in csr if c["case"] == "R0" and c["k"] == 1)
        k3 = next(c for c in dia if c["case"] == "S A0" and c["k"] == 1)
        common = dict(route="cuda", bound_by="bytes", values=v, vectors=t,
                      library="the (T, T) call on the widened values")
        entries += [
            dict(name=f"csr_spmv_capped_{pair}",
                 source="tpu_amg_torch/csrc/spmv.cu",
                 replaces="tpu_amg/ops/well_pallas.py:77",
                 launches=precision["totals"].get("K1", {}).get(pair, 0),
                 max_abs_err=max(c["err1"] for c in csr),
                 ms=k1["k1_ms"], plain_ms=k1["k1_plain_ms"],
                 bound_ms=k1["k1_bound_ms"], library_ms=k1["k1_lib_ms"],
                 tt_ms=k1["k1_tt_ms"], case=K1_HEADLINE, **common),
            dict(name=f"coo_patch_{pair}",
                 source="tpu_amg_torch/csrc/spmv.cu",
                 replaces="tpu_amg/ops/well_pallas.py:457",
                 launches=precision["totals"].get("K2", {}).get(pair, 0),
                 max_abs_err=max(c["err2"] for c in csr),
                 ms=k2["k2_ms"], plain_ms=k2["k2_plain_ms"],
                 bound_ms=k2["k2_bound_ms"], library_ms=k2["k2_lib_ms"],
                 tt_ms=k2["k2_tt_ms"], case="R0", **common),
            dict(name=f"dia_spmv_{pair}",
                 source="tpu_amg_torch/csrc/dia.cu",
                 replaces="tpu_amg/ops/dia_pallas.py:34",
                 launches=precision["totals"].get("K3", {}).get(pair, 0),
                 max_abs_err=max(c["err"] for c in dia),
                 ms=k3["ms"], plain_ms=k3["plain_ms"],
                 bound_ms=k3["bound_ms"], library_ms=k3["lib_ms"],
                 tt_ms=k3["tt_ms"], case="structured A0", **common),
        ]
    return entries


def row_design_entry(dia_results, precision, paths, floor_ms,
                     launches) -> dict:
    """The kernels line's entry of K3's row-chunk design (k < 8): every
    K3 case below TILED_MIN_K timed in this run in ``shapes``, each with
    its path's launches at that shape (``paths``: (case names, path,
    dtype the path runs, launches by (rows, cols, k)); a mixed pair's
    case carries phase 15's launches at its shape and pair), the
    row-chunk and first designs' times (in turns), the band tiles', K1 +
    K2's as CSR (not at the mixed pairs), the plain version's, the
    library's, the bound, the launch's fixed cost ``floor_ms`` and the
    share of the bound with and without it; launches x time summed over
    the shapes for both designs.  ``launches``: the structured path's
    (the main path's) row-chunk launches; its A0 at float64, k = 1 the
    headline."""
    from tpu_amg_torch.ops import dia as dia_ops

    short = {"float64": "f64", "float32": "f32"}
    rows = []
    for names, path, dtype, counts in paths:
        for c in dia_results:
            if c["case"] in names and c["k"] < dia_ops.TILED_MIN_K:
                rows.append(dict(
                    case=c["case"], path=path, pair=short[c["dtype"]],
                    rows=c["n"], diagonals=c["diagonals"], k=c["k"],
                    launches=(counts.get((c["n"], c["n"], c["k"]), 0)
                              if c["dtype"] == dtype else 0),
                    max_abs_err=c["err"], ms=c["ms"],
                    first_design_ms=c["first_ms"], band_tiles_ms=c["tiled_ms"],
                    csr_ms=c["csr_ms"], plain_ms=c["plain_ms"],
                    library_ms=c["lib_ms"], bound_ms=c["bound_ms"],
                    design=c["design"]))
    mixed = precision["totals"].get("K3 by shape", {})
    for c in precision["dia"]:
        if c["k"] < dia_ops.TILED_MIN_K:
            rows.append(dict(
                case=f"mixed {c['case']}", path="mixed precision",
                pair=c["pair"], rows=c["n"], diagonals=c["diagonals"],
                k=c["k"], launches=mixed.get((c["n"], c["n"], c["k"],
                                              c["pair"]), 0),
                max_abs_err=c["err"], ms=c["ms"],
                first_design_ms=c["first_ms"], band_tiles_ms=c["tiled_ms"],
                csr_ms=None, plain_ms=c["plain_ms"],
                library_ms=c["lib_ms"], bound_ms=c["bound_ms"]))
    for r in rows:
        r.update(floor_ms=floor_ms, share=r["bound_ms"] / r["ms"],
                 share_with_floor=(r["bound_ms"] + floor_ms) / r["ms"])
        say(f"K3 below k = {dia_ops.TILED_MIN_K}, {r['path']} {r['case']} "
            f"{r['pair']} k={r['k']} ({r['rows']} rows, {r['diagonals']} "
            f"diagonals): row-chunk {r['ms'] * 1e3:.2f} us, first design "
            f"{r['first_design_ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['share']:.1%}; with the "
            f"launch's {floor_ms * 1e3:.2f} us {r['share_with_floor']:.1%}), "
            f"launches {r['launches']}")
    new = sum(r["launches"] * r["ms"] for r in rows)
    old = sum(r["launches"] * r["first_design_ms"] for r in rows)
    say(f"K3 below k = {dia_ops.TILED_MIN_K}: launches x time over those "
        f"shapes {new:.3f} ms on the row-chunk design, {old:.3f} ms on the "
        f"first design")
    head = next(r for r in rows if r["case"] == "A0" and r["pair"] == "f64"
                and r["k"] == 1)
    return dict(
        name="dia_spmv_row", route="cuda", source="tpu_amg_torch/csrc/dia.cu",
        replaces="tpu_amg/ops/dia_pallas.py:34", launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows if r["pair"] == "f64"),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by="bytes", library_ms=head["library_ms"],
        case="structured A0", rows=head["rows"],
        first_design_ms=head["first_design_ms"], floor_ms=floor_ms,
        launches_x_ms=new, launches_x_first_design_ms=old, shapes=rows)


def drive(args, jobs, jobs_ckpt) -> list:
    """Phases 3-22 (the setups of phases 16-18 and 20 running in
    ``jobs``, the checkpoints they write in ``jobs_ckpt``, their
    directory ``jobs_ckpt["dir"]``); returns the kernels line's
    entries."""
    import torch

    from tpu_amg_torch.linop import SparseOperator
    from tpu_amg_torch.ops import (_build, dma, native, primitives, spmv,
                                   spmv_stages, stream)
    from tpu_amg_torch.ops import dia as dia_ops
    from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
    from tpu_amg_torch.solver import AMGSolver, SolverConfig, scalar_3d_config
    from tpu_amg_torch.solvers import cg
    from tpu_amg_torch.sparse.dia import DIA
    from tpu_amg_torch.structured import build_structured_multigrid
    from tpu_amg_torch.tools import diasweep, streambench
    from tpu_amg_torch.utils.problems import poisson3d, unstructured_poisson_3d
    from tpu_amg_torch.utils.testing import approx_convergence_factor
    from tpu_amg_torch.utils.timing import HBM_DATASHEET_GBPS, median_ms

    mark("3a")
    # ---- 3a. kernels vs plain on a heavy-row matrix with a small cap
    results = []
    heavy = heavy_row_matrix()
    kernel_cases(
        "heavy-row cap 16",
        {dt: spmv.CappedCSR.from_csr(heavy, "cuda", dt, cap=16)
         for dt in (torch.float64, torch.float32)},
        args.reps, results,
    )

    mark("3c")
    # ---- 3c. K1's kernels-line reading on the 262,144-row A0, read from
    # HBM (the matrix the SA path's A0 is at side 64), apart from --side
    t0 = time.perf_counter()
    head = unstructured_poisson_3d(K1_HEADLINE_SIDE)
    say(f"K1's headline matrix: unstructured_poisson_3d({K1_HEADLINE_SIDE})"
        f": n={head.nrows} nnz={head.nnz} built in "
        f"{time.perf_counter() - t0:.1f} s")
    kernel_cases(
        K1_HEADLINE,
        {dt: spmv.CappedCSR.from_csr(head, "cuda", dt)
         for dt in (torch.float64, torch.float32)},
        args.reps, results, ks=(1,),
    )

    mark("4")
    # ---- 4. main path
    t0 = time.perf_counter()
    a = unstructured_poisson_3d(args.side)
    say(f"problem: unstructured_poisson_3d({args.side}): n={a.nrows} "
        f"nnz={a.nnz} built in {time.perf_counter() - t0:.1f} s")
    cfg = scalar_3d_config("cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    solver = AMGSolver.setup(a, cfg)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    setup_counts = (spmv.csr_spmv_launches, spmv.coo_patch_launches)
    h = solver.hierarchy
    phases = " ".join(f"{k} {v:.1f} s" for k, v in solver.setup_seconds.items())
    say(f"setup: {t_setup:.1f} s ({phases}); levels {h.num_levels}; "
        f"op complexity {h.op_complexity():.3f}; "
        f"grid complexity {h.grid_complexity():.3f}")
    for lvl, m in enumerate(h.matrices):
        say(f"  level {lvl}: n={m.nrows} nnz={m.nnz} "
            f"({m.nnz / m.nrows:.1f}/row)")
    a_mat = solver.op.mat
    solve_s, graph_s, sa_iters = [], [], []
    for i in range(3):
        # b = A x_true for a seeded x_true, the reference's own protocol
        # (tools/solve3d.py:87-90)
        x_true = np.random.default_rng(100 + i).standard_normal(a.nrows)
        b = spmv.plain_spmv(a_mat, torch.from_numpy(x_true).cuda())
        pair = eager_and_compiled(solver, b, "cg", RTOL, 200)
        x, info, _ = pair[1]
        solve_s.append(pair[0][2])
        graph_s.append(pair[1][2])
        sa_iters.append(info.iters)
        true_rel = float(torch.linalg.vector_norm(b - spmv.plain_spmv(a_mat, x))
                         / torch.linalg.vector_norm(b))
        check(
            info.converged and info.iters <= MAX_ITERS
            and np.isfinite(true_rel) and true_rel <= 1.01 * RTOL
            and tuple(x.shape) == (a.nrows,),
            f"solve {i}: {graph_s[-1]:.3f} s, {info.iters} iterations "
            f"(limit {MAX_ITERS}), true relative residual {true_rel:.3e} "
            f"(limit {1.01 * RTOL:.3e})",
        )
        check_same_solve(f"SA PCG solve {i}", pair, first=i == 0)
    # the stationary solve, eager and compiled, and the ‖E‖_A estimate
    pair = eager_and_compiled(solver, b, "stationary", RTOL, STATIONARY_MAX)
    x, info, _ = pair[1]
    true_rel = float(torch.linalg.vector_norm(b - spmv.plain_spmv(a_mat, x))
                     / torch.linalg.vector_norm(b))
    check(info.converged and true_rel <= 1.01 * RTOL,
          f"SA stationary solve to rtol {RTOL:.0e} (at most "
          f"{STATIONARY_MAX}): converged {info.converged} in {info.iters} "
          f"iterations, true relative residual {true_rel:.3e}")
    check_same_solve("SA stationary solve", pair, first=True)
    sa_stationary = (pair[1][1].iters, pair[0][2], pair[1][2])
    t0 = time.perf_counter()
    e_norm = approx_convergence_factor(solver.op, solver.preconditioner)
    t_e = time.perf_counter() - t0
    check(0.0 < e_norm < 1.0,
          f"SA ||E||_A estimate (100 power steps x 5 vectors, K1's SpMM at "
          f"k=5 and the V-cycle on a block): {e_norm:.6f} (limit (0, 1)); "
          f"{t_e:.2f} s; ||E 1||_A / ||1||_A "
          f"{constant_mode_factor(solver.op, solver.preconditioner):.12f}")
    torch.cuda.synchronize()
    launches = (spmv.csr_spmv_launches, spmv.coo_patch_launches)
    k1_by_shape = dict(spmv.csr_spmv_launches_by_shape)
    k2_by_shape = dict(spmv.coo_patch_launches_by_shape)
    sa_designs = dict(spmv.csr_spmv_launches_by_design)
    say(f"the SA path (setup, solves, ||E||_A): K1 launches by design "
        f"{dict(sorted(sa_designs.items()))}")
    solve_counts = (launches[0] - setup_counts[0],
                    launches[1] - setup_counts[1])
    check(
        min(solve_counts) > 0 and min(launches) > 0
        and sum(k1_by_shape.values()) == launches[0]
        and sum(k2_by_shape.values()) == launches[1],
        f"launches over the SA path: csr_spmv_capped {launches[0]} "
        f"(solves {solve_counts[0]}), coo_patch {launches[1]} "
        f"(solves {solve_counts[1]}); csr_spmv_capped by (rows, cols, k): "
        + ", ".join(f"{key} {v}" for key, v in sorted(k1_by_shape.items()))
        + "; coo_patch by (rows, cols, k): "
        + ", ".join(f"{key} {v}" for key, v in sorted(k2_by_shape.items())),
    )
    r = torch.from_numpy(np.random.default_rng(7).standard_normal(a.nrows)).cuda()
    t_vc = median_ms(lambda: solver.apply_preconditioner(r), 20)
    t_vc_dev = median_ms(lambda: solver.apply_preconditioner(r), 20,
                         graph=True)
    say(f"V-cycle: {t_vc:.3f} ms as the solve runs it (enqueued from "
        f"Python), {t_vc_dev:.3f} ms on the device (CUDA graph replay); "
        f"PCG solves eager " + ", ".join(f"{s:.4f}" for s in solve_s)
        + " s, compiled " + ", ".join(f"{s:.4f}" for s in graph_s) + " s")
    # the checkpoint: save, load, and the same V-cycle bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        solver.save(Path(tmp) / "sa.npz")
        t_save = time.perf_counter() - t0
        size = (Path(tmp) / "sa.npz").stat().st_size
        t0 = time.perf_counter()
        loaded = AMGSolver.load(Path(tmp) / "sa.npz", a, cfg)
        t_load = time.perf_counter() - t0
    same = torch.equal(loaded.apply_preconditioner(r),
                       solver.apply_preconditioner(r))
    check(same, f"checkpoint: save {t_save:.1f} s ({size / 1e6:.1f} MB), "
          f"load + multigrid build {t_load:.1f} s; the loaded V-cycle is "
          f"bitwise equal to the original on a seeded vector: {same}")
    del loaded

    mark("3b")
    # ---- 3b. kernels vs plain at every sparse matrix of the main path
    k_boot = cfg.coarsening_near_null_dim - 1  # the bootstrap's block width
    levels = solver.preconditioner.levels

    def sa_mat(letter, lvl, csr):
        """The float64 matrix the solver itself runs (its row-block table
        included) where it is a CappedCSR; else one built from ``csr``."""
        op = (getattr(levels[lvl], letter.lower()) if lvl < len(levels)
              else None)
        mat = getattr(op, "mat", None)
        return (mat if isinstance(mat, spmv.CappedCSR)
                else spmv.CappedCSR.from_csr(csr, "cuda", torch.float64))

    # (every A, P and R of the hierarchy that K1 ran on, and levels 0-1's)
    sa_cases = {}
    for lvl in range(h.num_levels):
        for letter, host in (("A", h.matrices), ("P", h.interpolations),
                             ("R", h.restrictions)):
            if lvl >= len(host):
                continue
            name, csr = f"{letter}{lvl}", host[lvl]
            ran = {key[2] for key in k1_by_shape if key[:2] == csr.shape}
            if not ran and lvl > 1:
                continue
            sa_cases[name] = csr.shape
            ks = {1, 8} | ran | ({k_boot} if name == "A0" else set())
            kernel_cases(
                name,
                {torch.float64: sa_mat(letter, lvl, csr),
                 torch.float32: spmv.CappedCSR.from_csr(csr, "cuda",
                                                        torch.float32)},
                args.reps, results, sorted(ks),
            )
    check({"A0", "P0", "R0", "A1", "P1", "R1"} <= set(sa_cases),
          "sparse matrices of the SA path timed: " + ", ".join(
              f"{k} {v}" for k, v in sa_cases.items()))
    # K1's and K2's excess over their bounds on the SA path

    mark("5")
    # ---- 5. small input: card vs the plain versions on the CPU
    small = unstructured_poisson_3d(16)
    scfg = scalar_3d_config("cuda", coarsest_dim=100, dense_threshold=200)
    s_gpu = AMGSolver.setup(small, scfg)
    mg_cpu = MultigridConfig(
        smoother=scfg.smoother, smoothing_steps=scfg.smoothing_steps,
        dense_threshold=scfg.dense_threshold, device="cpu",
    ).build(s_gpu.hierarchy)
    op_cpu = SparseOperator.from_csr(small, "cpu")
    b_np = np.random.default_rng(3).standard_normal(small.nrows)
    xg, ig = s_gpu.solve(b_np, rtol=RTOL)
    xc, ic = cg(op_cpu, torch.from_numpy(b_np), mg_cpu, rtol=RTOL)
    dx = float((xg.cpu() - xc).abs().max() / xc.abs().max())
    zg = s_gpu.apply_preconditioner(b_np).cpu()
    zc = mg_cpu.mv(torch.from_numpy(b_np))
    dz = float((zg - zc).abs().max() / zc.abs().max())
    check(
        ig.converged and ig.iters == ic.iters and dz <= 1e-10 and dx <= 1e-6,
        f"small input n={small.nrows}, {s_gpu.hierarchy.num_levels} levels: "
        f"card {ig.iters} / CPU {ic.iters} iterations; V-cycle rel diff "
        f"{dz:.2e} (limit 1e-10); solution rel diff {dx:.2e} (limit 1e-6)",
    )
    # ||E||_A on this hierarchy, card against CPU, from one start block
    starts = torch.randn(small.nrows, 5, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(42))
    for steps, tol in E_NORM_CASES:
        eg, ec = (approx_convergence_factor(op, pc, num_iters=steps,
                                            starts=starts)
                  for op, pc in ((s_gpu.op, s_gpu.preconditioner),
                                 (op_cpu, mg_cpu)))
        de = abs(eg - ec) / ec
        check(0.0 < eg < 1.0 and de <= tol,
              f"small input ||E||_A after {steps} power steps: card "
              f"{eg:.12f}, CPU {ec:.12f}, rel diff {de:.2e} (limit "
              f"{tol:.0e})")
    say(f"small input ||E 1||_A / ||1||_A: card "
        f"{constant_mode_factor(s_gpu.op, s_gpu.preconditioner):.12f}, CPU "
        f"{constant_mode_factor(op_cpu, mg_cpu):.12f}")

    mark("6")
    # ---- 6. stream probe: its entry point, then each case vs plain
    reset_counts()
    bench_recs = streambench.run(["--total-mib", str(STREAM_MIB), "--reps",
                                  str(args.reps)])
    torch.cuda.synchronize()
    stream_launches = stream.stream_sum_launches
    check(stream_launches > 0,
          f"launches over the stream probe: stream_sum {stream_launches}")
    stream_recs, best, bigs, big = stream_cases(bench_recs, args.reps)
    say(f"stream read bandwidth: best float32 case {best['name']!r}: "
        f"{best['gbps']:.1f} GB/s at {STREAM_MIB} MiB per call (held in "
        f"the 50 MB L2); best at {STREAM_BIG_MIB} MiB {big['name']!r}: "
        f"{big['gbps']:.1f} GB/s ({big['ms'] * 1e3:.1f} us per call): "
        f"device memory, "
        f"{big['gbps'] / HBM_DATASHEET_GBPS:.1%} of the "
        f"{HBM_DATASHEET_GBPS:.0f} GB/s data sheet; plain version "
        f"(torch.sum) {big['plain_gbps']:.1f} GB/s "
        f"({big['plain_ms'] * 1e3:.1f} us); copy probe "
        f"({COPY_BEST}, best engine) {big['copy_gbps']:.1f} GB/s")

    mark("7")
    # ---- 7. structured path: DIA levels through K3
    side = STRUCTURED_SIDE
    t0 = time.perf_counter()
    ps = poisson3d(side)
    say(f"problem: poisson3d({side}): n={ps.nrows} nnz={ps.nnz} built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    smg = build_structured_multigrid(ps, (side,) * 3, device="cuda",
                                     coarsest_dim=1000, dtype=torch.float64)
    s_solver = AMGSolver(ps, smg, config=SolverConfig(device="cuda"))
    s_op = s_solver.op
    torch.cuda.synchronize()
    say(f"structured setup: {time.perf_counter() - t0:.1f} s; "
        f"{len(smg.levels) + 1} levels")
    for line in level_lines(smg):
        say(line)
    check(isinstance(s_op.mat, DIA), f"structured A is "
          f"{type(s_op.mat).__name__} (expected DIA)")
    s_solve, s_graph = [], []
    for i in range(3):
        x_true = np.random.default_rng(100 + i).standard_normal(ps.nrows)
        b = dia_ops.plain_dia_spmv(s_op.mat, torch.from_numpy(x_true).cuda())
        pair = eager_and_compiled(s_solver, b, "cg", RTOL, 200)
        x, info, _ = pair[1]
        s_solve.append(pair[0][2])
        s_graph.append(pair[1][2])
        true_rel = float(
            torch.linalg.vector_norm(b - dia_ops.plain_dia_spmv(s_op.mat, x))
            / torch.linalg.vector_norm(b))
        check(
            info.converged and info.iters <= MAX_ITERS_STRUCTURED
            and np.isfinite(true_rel) and true_rel <= 1.01 * RTOL
            and tuple(x.shape) == (ps.nrows,),
            f"structured solve {i}: {s_graph[-1]:.3f} s, {info.iters} "
            f"iterations (limit {MAX_ITERS_STRUCTURED}), true relative "
            f"residual {true_rel:.3e} (limit {1.01 * RTOL:.3e})",
        )
        check_same_solve(f"structured PCG solve {i}", pair, first=i == 0)
    pair = eager_and_compiled(s_solver, b, "stationary", RTOL, STATIONARY_MAX)
    check(pair[1][1].converged,
          f"structured stationary solve to rtol {RTOL:.0e}: converged "
          f"{pair[1][1].converged} in {pair[1][1].iters} iterations")
    check_same_solve("structured stationary solve", pair, first=True)
    s_stationary = (pair[1][1].iters, pair[0][2], pair[1][2])
    del pair, x
    torch.cuda.synchronize()
    s_launches = dict(dia_spmv=dia_ops.dia_spmv_launches,
                      csr_spmv_capped=spmv.csr_spmv_launches,
                      coo_patch=spmv.coo_patch_launches)
    s_k2_by_shape = dict(spmv.coo_patch_launches_by_shape)
    s_k3_by_shape = dict(dia_ops.dia_spmv_launches_by_shape)
    csr_levels = [lvl.a.mat for lvl in smg.levels
                  if isinstance(lvl.a, SparseOperator)
                  and not isinstance(lvl.a.mat, DIA)]
    check(
        s_launches["dia_spmv"] > 0
        and (not csr_levels or s_launches["csr_spmv_capped"] > 0)
        and (not any(m.n_tail for m in csr_levels)
             or s_launches["coo_patch"] > 0),
        "launches over the structured path: " + ", ".join(
            f"{k} {v}" for k, v in s_launches.items())
        + "; coo_patch by (rows, cols, k): " + ", ".join(
            f"{key} {v}" for key, v in sorted(s_k2_by_shape.items())),
    )
    rs = torch.from_numpy(np.random.default_rng(7).standard_normal(ps.nrows)).cuda()
    t_svc = median_ms(lambda: smg.mv(rs), 20)
    t_svc_dev = median_ms(lambda: smg.mv(rs), 20, graph=True)
    say(f"structured V-cycle: {t_svc:.3f} ms as the solve runs it "
        f"(enqueued from Python), {t_svc_dev:.3f} ms on the device (CUDA "
        f"graph replay); PCG solves eager "
        + ", ".join(f"{s:.4f}" for s in s_solve) + " s, compiled "
        + ", ".join(f"{s:.4f}" for s in s_graph) + " s")

    mark("8")
    # ---- 8. K3 vs plain at the structured path's level-0 and level-1 shapes
    dia_results = []
    for lvl, name in ((0, "A0"), (1, "A1")):
        mat = smg.levels[lvl].a.mat
        check(isinstance(mat, DIA), f"structured level {lvl} is DIA")
        dia_kernel_cases(name, mat, ps if lvl == 0 else dia_to_csr(mat),
                         args.reps, dia_results)
    # K3's diagonal sweep at k = 64, float64, 262,144 rows: both designs
    floor_ms = diasweep.floor_case(args.reps)
    say(f"K3's row-chunk design: the fixed cost of a launch in a graph (one "
        f"diagonal, {diasweep.FLOOR_ROWS} rows, float32, k = 1) "
        f"{floor_ms * 1e3:.2f} us")
    sweep = diasweep.sweep(args.reps)
    say(diasweep.say_sweep(sweep))
    check(all(r["same"] for r in sweep.values()),
          "K3's diagonal sweep: the band tiles bitwise equal to the first "
          "design on every offset set")
    check(len(csr_levels) > 0, f"the structured path has "
          f"{len(csr_levels)} CSR levels (expected level 2)")
    s_cases = set()
    for lvl, level in enumerate(smg.levels):
        mat = getattr(level.a, "mat", None)
        if isinstance(mat, spmv.CappedCSR):
            s_cases.add(f"S{lvl}")
            ran = {key[2] for key in s_k2_by_shape if key[:2] == mat.shape}
            kernel_cases(
                f"S{lvl}",
                {torch.float64: mat,
                 torch.float32: spmv.CappedCSR.from_csr(
                     mat.to_csr(), "cuda", torch.float32)},
                args.reps, results, sorted({1, 8} | ran),
            )

    mark("9")
    # ---- 9. small structured input: card vs the plain versions on the CPU
    n24 = 24
    small_s = poisson3d(n24)
    mgs = {dev: build_structured_multigrid(
        small_s, (n24,) * 3, device=dev, coarsest_dim=64, dtype=torch.float64)
        for dev in ("cuda", "cpu")}
    b_np = np.random.default_rng(3).standard_normal(small_s.nrows)
    sols = {}
    for dev, mg in mgs.items():
        op = SparseOperator.from_csr(small_s, dev, torch.float64)
        b_dev = torch.from_numpy(b_np).to(dev)
        x, info = cg(op, b_dev, mg, rtol=RTOL)
        sols[dev] = (x.cpu(), info, mg.mv(b_dev).cpu())
    (xg, ig, zg), (xc, ic, zc) = sols["cuda"], sols["cpu"]
    dz = float((zg - zc).abs().max() / zc.abs().max())
    dx = float((xg - xc).abs().max() / xc.abs().max())
    check(
        ig.converged and ig.iters == ic.iters and dz <= 1e-10 and dx <= 1e-6,
        f"small structured input poisson3d({n24}), {len(mgs['cuda'].levels) + 1} "
        f"levels: card {ig.iters} / CPU {ic.iters} iterations; V-cycle rel "
        f"diff {dz:.2e} (limit 1e-10); solution rel diff {dx:.2e} "
        f"(limit 1e-6)",
    )

    mark("10-12")
    # ---- 10-12. the stage ablation, the copy probes, the primitives
    stages_entry, fem_k1 = ablation_phase(
        {"SA A0": a_mat, "SA R0": sa_mat("R", 0, h.restrictions[0]),
         "SA A1": sa_mat("A", 1, h.matrices[1])},
        args.reps)
    l2, dma_entry = dma_phase(args.reps)
    primitives_entry = primitives_phase(args.reps)

    mark("13")
    # ---- 13. the CLI on the card (its longest runs in the setup workers)
    cli_totals = cli_phase()

    # ---- 14. the adaptive composite at 262,144 dofs, from the float64
    # setup of a worker
    mark("14")
    t0 = time.perf_counter()
    a_setup = jobs["adaptive f64"].get(timeout=JOB_WAIT)
    say(f"phase 14: the adaptive setup's worker done "
        f"{time.perf_counter() - t0:.1f} s after phase 13")
    adaptive = adaptive_phase(a_setup, args.reps, results, dia_results)

    mark("15")
    # ---- 15. mixed-precision cycles on the hierarchies of 4, 5, 7, 14
    precision = precision_phase(args.reps, l2, dict(
        head=head, sa=solver, small=(s_gpu, mg_cpu, op_cpu),
        structured=s_solver, adaptive=adaptive["solver"],
        adaptive_small=adaptive["small"]))

    mark("22")
    # ---- 22. the SpMV throughput benchmark on phase 7's and 10's 1M
    # matrices, its K3 and K1 applies timed in turns with the calls that
    # phases 15 and 10 timed on the same matrices
    k3_bf16 = next(c for c in precision["dia"] if c["case"] == "S A0"
                   and c["pair"] == "bf16f32" and c["k"] == 1)
    p22 = bench_phase(ps, fem_k1, s_solver.preconditioner.levels[0].a.mat,
                      k3_bf16["ms"], args.reps, l2)
    bench_launches = p22["launches"]

    mark("16")
    # ---- 16. block-3 elasticity, from the float64 setup of a worker
    t0 = time.perf_counter()
    e_setup = jobs["elasticity f64"].get(timeout=JOB_WAIT)
    say(f"phase 16: the elasticity setup's worker done "
        f"{time.perf_counter() - t0:.1f} s after phase 22")
    elasticity = elasticity_phase(e_setup, e_setup["ckpt"], args.reps,
                                  results)

    mark("17")
    # ---- 17. the float32 bootstrap against phases 4, 16 and 14
    t0 = time.perf_counter()
    f32 = {name.split()[0]: jobs[name].get(timeout=JOB_WAIT)
           for name in ("SA f32", "elasticity f32", "adaptive f32")}
    say(f"phase 17: the float32-bootstrap setups' workers done "
        f"{time.perf_counter() - t0:.1f} s after phase 16")
    a_solver = adaptive["solver"]
    refs = {
        "SA": dict(near_null=solver.setup_seconds["near_null"],
                   rows=[[m.nrows for m in h.matrices]], iters=sa_iters[0],
                   jax=JAX_ITERS["SA"], kernel="K1"),
        "elasticity": dict(near_null=e_setup["seconds"]["near_null"],
                           rows=e_setup["rows"], iters=elasticity["iters"],
                           jax=JAX_ITERS["elasticity"], kernel="K1"),
        "adaptive": dict(near_null=adaptive["near_null_s"],
                         rows=[[m.nrows for m in hh.matrices]
                               for hh in a_solver.component_hierarchies],
                         iters=adaptive["peel_iters"], kernel="K3"),
    }
    boot = bootstrap_phase(f32, refs, results, dia_results)

    mark("18")
    # ---- 18. classical AMG, from the setup of a worker
    t0 = time.perf_counter()
    c_setup = jobs["classical"].get(timeout=JOB_WAIT)
    say(f"phase 18: the classical setup's worker done "
        f"{time.perf_counter() - t0:.1f} s after phase 17")
    classical = classical_phase(c_setup, jobs_ckpt["classical"], args.reps,
                                results, dia_results)

    mark("13 (the setup workers' CLI runs)")
    # ---- 13, the CLI runs of the setup workers
    cli_worker_phase(jobs, cli_totals)

    mark("21 (its operators)")
    # ---- 21, its operators: phases 4's and 16's paths over containers
    trees = container_trees(solver, elasticity["solver"])

    mark("19")
    # ---- 19. distribution: NCCL at world size 1, gloo ranks on the card
    # (and phase 21 (c) in its NCCL group)
    dist_out = distributed_phase(solver, s_op, smg, args.side, args.reps,
                                 results, dia_results, trees["SA"])

    mark("20")
    # ---- 20. the rest of M21: the V-cycle benches, the real-FEM solve,
    # the breakdown, the aggregation tool and --viz-out
    p20 = slice14_phase(jobs, args.reps, results, dia_results, solver,
                        adaptive["solver"].preconditioner, jobs_ckpt["dir"])

    # the rows timed in L2 (bytes that fit in the card's L2, 50 calls
    # back to back) bound by this run's L2 read rate, without a call's
    # fixed cost (phase 11), in place of the HBM data sheet's rate
    # every path that runs K3 below k = 8, solved again with those
    # launches on the first design (after every path's counts were read)
    vc_mg, fem_solver = p20["vcycle"]["multigrid"], p20["fem"]["solver"]
    first_design_solves([
        (f"structured path poisson3d({STRUCTURED_SIDE}), float64", s_op, smg,
         RTOL, 200),
        (f"adaptive composite aniso2d({ADAPTIVE_N}) random",
         adaptive["solver"].op, adaptive["solver"].preconditioner,
         ADAPTIVE_TOL, ADAPTIVE_MAXITER),
        (f"classical W-cycle poisson2d({CLASSICAL_SIDE})",
         classical["solver"].op, classical["solver"].preconditioner,
         CLASSICAL_TOL, 200),
        ("bench_vcycle poisson3d(64), float32", vc_mg.levels[0].a, vc_mg,
         RTOL, 200),
        ("real FEM, float32", fem_solver.op, fem_solver.preconditioner, RTOL,
         FEM_MAXITER)])

    mark("21")
    # ---- 21. the ELL and BSR containers: (a) K1 + K2 on them, (b) the
    # SA and elasticity solves over them ((c) ran in phase 19)
    t0 = time.perf_counter()
    container_kernel_cases(trees, args.reps, results)
    c_solves = container_solves(trees)
    c_seconds = (time.perf_counter() - t0 + dist_out["nccl SA over ELLs"]
                 ["seconds"] + sum(t["seconds"] for t in trees.values()))
    say(f"phase 21: {c_seconds:.1f} s (its operators' build, (a), (b) and "
        f"(c) in phase 19)")

    bound_in_l2(results, dia_results, stream_recs, l2)
    # K1's and K2's excess over their bounds on both paths
    say_excess("K1", "k1", "the SA path", k1_by_shape, results, sa_cases)
    say_excess("K2", "k2", "the SA path", k2_by_shape, results, sa_cases)
    say_excess("K2", "k2", "the structured path", s_k2_by_shape, results,
               s_cases)
    say_adaptive_excess(adaptive, results, dia_results)
    # K1's and K2's two designs at k > 1 on every path that launches them,
    # and K1's launches by design against the router's picks
    design_excess = {
        "SA": say_design_excess("the SA path", k1_by_shape, k2_by_shape,
                                results, cases=sa_cases,
                                k1_designs=sa_designs),
        "adaptive": say_design_excess(
            "the adaptive path", adaptive["counts"]["K1"],
            adaptive["counts"]["K2"], results, cases=adaptive["csr_cases"],
            k1_designs=adaptive["counts"]["K1 designs"]),
        "elasticity": say_design_excess(
            "the elasticity path", elasticity["by_shape"]["K1"],
            elasticity["by_shape"]["K2"], results,
            cases=elasticity["cases"], k1_designs=elasticity["k1_designs"]),
        "classical": say_design_excess(
            "the classical path", classical["by_shape"]["K1"],
            classical["by_shape"]["K2"], results, cases=classical["cases"],
            k1_designs=classical["k1_designs"]),
    }
    for name, run in boot["runs"].items():
        design_excess[f"f32 bootstrap {name}"] = say_design_excess(
            f"the float32 bootstrap's {name} setup",
            run["counts"]["K1"]["by_shape"], run["counts"]["K2"]["by_shape"],
            results, dtype="float32",
            k1_designs=run["counts"]["K1"]["by_design"])

    mark("23")
    # ---- 23. the design sweep on the paths' own matrices
    sweep_mats = {"SA A0": sa_mat("A", 0, h.matrices[0]),
                  "SA R0": sa_mat("R", 0, h.restrictions[0]),
                  "SA A1": sa_mat("A", 1, h.matrices[1])}
    for name in ("adaptive c1 P0", "adaptive c1 R0", "adaptive c1 A1",
                 "adaptive c1 R2"):
        if name in adaptive["csr_mats"]:
            sweep_mats[name] = adaptive["csr_mats"][name]
    for name in ("elasticity A0", "classical A1"):
        path = elasticity if name.startswith("elasticity") else classical
        if name in path["mats"]:
            sweep_mats[name] = path["mats"][name]
    spmm_sweep = spmm_sweep_phase(sweep_mats, SWEEP_REPS)

    mark("results")
    # ---- results
    # both paths run float64: their errors go in the record, the SA
    # path's level-0 times beside them
    main_cases = [c for c in results
                  if (c["case"] in sa_cases or c["case"].startswith("S")
                      or c["case"] == K1_HEADLINE)
                  and c["dtype"] == "float64"]
    a0 = next(c for c in main_cases if c["case"] == K1_HEADLINE)
    r0 = next(c for c in main_cases if c["case"] == "R0" and c["k"] == 1)
    s2 = next(c for c in main_cases if c["case"] == "S2" and c["k"] == 1)
    d0 = next(c for c in dia_results if c["case"] == "A0"
              and c["dtype"] == "float64" and c["k"] == 1)
    d1 = next(c for c in dia_results if c["case"] == "A1"
              and c["dtype"] == "float64" and c["k"] == 1)
    adaptive_cases = [c for c in results if c["case"] in adaptive["csr_cases"]
                      and c["dtype"] == "float64"]
    k64, d64 = adaptive["k64"], adaptive["d64"]
    t64 = max((c for c in adaptive_cases if c["k"] == 64
               and c.get("k2_pieces_ms") is not None),
              key=lambda c: c["n_tail"])
    kernels = [
        dict(name="csr_spmv_capped", route="cuda",
             source="tpu_amg_torch/csrc/spmv.cu",
             replaces="tpu_amg/ops/well_pallas.py:77",
             launches=launches[0],
             # phase 22's (tools.bench: "csr", "ell" and the FEM 1M)
             launches_bench=bench_launches["K1"],
             bench={n: p22["applies"][n]
                    for n in ("csr", "ell", "fem", "fem_bf16v")},
             max_abs_err=max(c["err1"] for c in main_cases),
             ms=a0["k1_ms"], plain_ms=a0["k1_plain_ms"],
             bound_ms=a0["k1_bound_ms"], bound_by="bytes",
             library_ms=a0["k1_lib_ms"],
             # the matrix of ms, plain_ms, bound_ms and library_ms (k = 1)
             case=K1_HEADLINE, rows=a0["shape"][0],
             # the adaptive path (phase 14): its launches, and its largest
             # matrix at k = 64 (the enrichment's block of candidates)
             launches_adaptive=sum(adaptive["counts"]["K1"].values()),
             max_abs_err_adaptive=max(c["err1"] for c in adaptive_cases),
             k64_case=k64["case"], k64_ms=k64["k1_ms"],
             k64_plain_ms=k64["k1_plain_ms"],
             k64_bound_ms=k64["k1_bound_ms"],
             k64_library_ms=k64["k1_lib_ms"],
             # the two SpMM designs at k = 64 (in turns), the X rows the
             # first one gathers over the L2 rate, the router's rule (X
             # row bytes staged, mean capped row length, X row bytes
             # gathered), the sweep's sums of the first, staged and routed
             # times by dtype, launches by design on the SA and adaptive
             # paths, and launches x time at k > 1 by path (routed, first,
             # staged)
             k64_staged_ms=k64["k1_staged_ms"],
             k64_first_ms=k64["k1_first_ms"],
             k64_gather_ms=k64.get("k1_gather_ms"),
             router=dict(stage_row=spmv.SPMM_STAGE_ROW,
                         short_rows=spmv.SPMM_SHORT_ROWS,
                         gather_row=spmv.SPMM_GATHER_ROW),
             sweep_ms={d: [round(v[key], 6) for key in (
                 "k1_first_ms", "k1_staged_ms", "k1_routed_ms")]
                 for d, v in spmm_sweep["sums"].items()},
             launches_by_design=sa_designs,
             launches_by_design_adaptive=dict(
                 adaptive["counts"]["K1 designs"]),
             launches_x_ms_k_gt_1={
                 path: [round(v, 6) for v in e["K1"]["ms"].values()]
                 for path, e in design_excess.items()
                 if e["K1"]["launches"]}),
        dict(name="coo_patch", route="cuda",
             source="tpu_amg_torch/csrc/spmv.cu",
             replaces="tpu_amg/ops/well_pallas.py:457",
             launches=launches[1],
             launches_bench=bench_launches["K2"],
             max_abs_err=max(c["err2"] for c in main_cases),
             ms=r0["k2_ms"], plain_ms=r0["k2_plain_ms"],
             bound_ms=r0["k2_bound_ms"], bound_by="bytes",
             library_ms=r0["k2_lib_ms"],
             # the SA path's R0 at --side (k = 1)
             case=f"R0 side {args.side}", rows=r0["shape"][0],
             # the structured path's level 2 (f64, k = 1) beside R0's tail
             launches_structured=s_launches["coo_patch"],
             level2_ms=s2["k2_ms"], level2_plain_ms=s2["k2_plain_ms"],
             level2_bound_ms=s2["k2_bound_ms"],
             level2_library_ms=s2["k2_lib_ms"],
             launches_adaptive=sum(adaptive["counts"]["K2"].values()),
             max_abs_err_adaptive=max(c["err2"] for c in adaptive_cases),
             # the adaptive path's longest tail at k = 64: the pieces
             # beside the rows design (in turns), as for K1
             k64_case=t64["case"], k64_ms=t64["k2_ms"],
             k64_pieces_ms=t64["k2_pieces_ms"],
             k64_rows_ms=t64["k2_rows_ms"],
             k64_plain_ms=t64["k2_plain_ms"],
             k64_bound_ms=t64["k2_bound_ms"],
             k64_library_ms=t64["k2_lib_ms"],
             k64_gather_ms=t64.get("k2_gather_ms"),
             # the pieces at every k > 1 (the rows design at k = 1), the
             # sweep's sums of the rows and pieces times by dtype, and
             # launches x time at k > 1 by path (pieces, rows)
             pieces_from_k=2,
             sweep_ms={d: [round(v[key], 6) for key in (
                 "k2_rows_ms", "k2_pieces_ms")]
                 for d, v in spmm_sweep["sums"].items()},
             launches_by_design={
                 "rows": sum(n for s_, n in k2_by_shape.items()
                             if s_[2] == 1),
                 "pieces": sum(n for s_, n in k2_by_shape.items()
                               if s_[2] > 1)},
             launches_x_ms_k_gt_1={
                 path: [round(v, 6) for v in e["K2"]["ms"].values()]
                 for path, e in design_excess.items()
                 if e["K2"]["launches"]}),
        # the structured path runs float64 at A0 and A1
        dict(name="dia_spmv", route="cuda",
             source="tpu_amg_torch/csrc/dia.cu",
             replaces="tpu_amg/ops/dia_pallas.py:34",
             launches=s_launches["dia_spmv"],
             # phase 22's ("dia" and the bf16-value DIA)
             launches_bench=bench_launches["K3"],
             bench={n: p22["applies"][n] for n in ("dia", "dia_bf16v")},
             max_abs_err=max(c["err"] for c in dia_results
                             if c["dtype"] == "float64"),
             ms=d0["ms"], plain_ms=d0["plain_ms"],
             bound_ms=d0["bound_ms"], bound_by="bytes",
             library_ms=d0["lib_ms"],
             # the level-1 operator, whose bytes stay in L2
             a1_ms=d1["ms"], a1_bound_ms=d1["bound_ms"],
             # the adaptive path's fine A (9 diagonals) at k = 64: the
             # band-tile design beside its first design
             launches_adaptive=sum(adaptive["counts"]["K3"].values()),
             k64_case=d64["case"], k64_rows=d64["n"],
             k64_diagonals=d64["diagonals"], k64_bands=d64["bands"],
             k64_ms=d64["ms"], k64_first_design_ms=d64["first_ms"],
             k64_plain_ms=d64["plain_ms"], k64_bound_ms=d64["bound_ms"],
             k64_library_ms=d64["lib_ms"], k64_csr_ms=d64["csr_ms"]),
        # the best float32 case past L2, where the HBM rate is a floor
        dict(name="stream_sum", route="cuda",
             source="tpu_amg_torch/csrc/stream.cu",
             replaces="tools/streambench.py:38, tools/streambench.py:96",
             launches=stream_launches,
             max_abs_err=max(r["err"] for r in stream_recs + bigs),
             case=f"{big['name']} at {STREAM_BIG_MIB} MiB",
             ms=big["ms"], plain_ms=big["plain_ms"],
             bound_ms=big["bound_ms"], bound_by="bytes",
             library_ms=big["plain_ms"],
             # the best float32 case at 32 MiB, bound in L2, beside
             # torch.sum over the same view
             l2_case=best["name"], l2_ms=best["ms"],
             l2_plain_ms=best["plain_ms"], l2_bound_ms=best["bound_ms"]),
        stages_entry, dma_entry, primitives_entry,
        *precision_entries(precision),
        *slice11_entries(elasticity, boot),
        *classical_entries(classical),
        *distributed_entries(dist_out, results, dia_results),
        *slice14_entries(p20, results, dia_results),
        *container_entries(c_solves, dist_out["nccl SA over ELLs"], results),
        row_design_entry(dia_results, precision, [
            (("A0", "A1"), "structured", "float64", s_k3_by_shape),
            (adaptive["dia_cases"], "adaptive", "float64",
             adaptive["counts"]["K3"]),
            (("classical A0",), "classical", "float64",
             classical["by_shape"]["K3"]),
            ((dist_out["cases"]["K3"][0],), "distributed", "float64",
             dist_by_shape(dist_out)["K3"]),
            (p20["vcycle"]["cases"], "bench_vcycle", "float32",
             p20["vcycle"]["counts"]["K3"]),
            (p20["fem"]["cases"], "real FEM", "float32",
             p20["fem"]["counts"]["K3"])], floor_ms,
            sum(v for key, v in s_k3_by_shape.items()
                if key[2] < dia_ops.TILED_MIN_K)),
    ]
    return kernels


# ---- phase 21: the ELL and BSR containers

# (b)'s and (c)'s container solves against the CSR-backed ones: x within
# this relative difference (bitwise where the containers' capped CSRs are
# the CSRs' own, as from_csr builds them)
CONTAINER_RTOL = 1e-12
KS_CONTAINER = (1, 8)  # (a)'s columns


def container_tree(op, memo: dict, formats: dict):
    """``op`` with every SparseOperator over a CappedCSR rebuilt over a
    container from that CSR's own entries, on its device in its dtype:
    a BSR where the operator is square with a block size above 1, else
    an ELL (the JAX package's ``_pick_format`` rules 4 and 5, which pick
    them on any device but a TPU); DIA, dense and other operators kept,
    an operator reached twice (a level's A in its smoother) rebuilt once
    (``memo``, by id).  ``formats`` gets (rows, cols) -> "ELL" or "BSR"
    for every container built."""
    from tpu_amg_torch.linop import SparseOperator
    from tpu_amg_torch.ops.spmv import CappedCSR
    from tpu_amg_torch.sparse import BSR, ELL

    if op is None or isinstance(op, (bool, int, float, str)):
        return op
    key = id(op)
    if key in memo:
        return memo[key]
    if isinstance(op, SparseOperator) and isinstance(op.mat, CappedCSR):
        block = op.shape[0] == op.shape[1] and op.block_size > 1

        def rebuild(mat):
            if not isinstance(mat, CappedCSR):
                return mat
            csr = mat.to_csr().with_block_size(op.block_size)
            formats[tuple(mat.shape)] = "BSR" if block else "ELL"
            if block:
                return BSR.from_csr(csr, mat.device, dtype=mat.dtype)
            return ELL.from_csr(csr, mat.device, mat.dtype)

        out = dataclasses.replace(op, mat=rebuild(op.mat),
                                  mat_t=rebuild(op.mat_t))
    elif dataclasses.is_dataclass(op) and not isinstance(op, type):
        changes = {}
        for f in dataclasses.fields(op):
            v = getattr(op, f.name)
            nv = container_tree(v, memo, formats)
            if nv is not v:
                changes[f.name] = nv
        out = dataclasses.replace(op, **changes) if changes else op
    elif isinstance(op, (tuple, list)):
        items = [container_tree(v, memo, formats) for v in op]
        out = (type(op)(items)
               if any(a is not b for a, b in zip(items, op)) else op)
    else:
        out = op
    memo[key] = out
    return out


def container_trees(sa_solver, e_solver) -> dict:
    """Phase 21's operators, built once before phase 19: phase 4's SA
    solver and phase 16's elasticity solver with A and every sparse
    level of the cycle over containers (:func:`container_tree`): the
    square levels of a block size above 1 as BSRs (the elasticity A0 and
    A1, blocks 3 and 6; the SA A1, block 2), the rest as ELLs."""
    import torch

    from tpu_amg_torch.solver import AMGSolver

    trees = {}
    for label, solver in (("SA", sa_solver), ("elasticity", e_solver)):
        t0 = time.perf_counter()
        memo, formats = {}, {}
        op = container_tree(solver.op, memo, formats)
        pc = container_tree(solver.preconditioner, memo, formats)
        torch.cuda.synchronize()
        trees[label] = dict(
            csr=solver, op=op, pc=pc, seconds=time.perf_counter() - t0,
            solver=AMGSolver(solver.matrix, pc, hierarchy=solver.hierarchy,
                             config=solver.config, op=op),
            formats=formats)
        say(f"phase 21: the {label} path over containers built in "
            f"{trees[label]['seconds']:.1f} s: A {type(op.mat).__name__} "
            f"(k {op.mat.k}, {op.mat.nnz} entries); by (rows, cols): "
            + ", ".join(f"{s} {f}" for s, f in
                        sorted(trees[label]["formats"].items())))
    return trees


def same_capped(a, b) -> bool:
    import torch

    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("indptr", "indices", "data", "tail_cols",
                         "tail_vals"))


def container_kernel_cases(trees, reps, results) -> dict:
    """Phase 21 (a): K1 + K2 on the SA path's A0 and R0 as ELLs and the
    elasticity path's A0 (bs 3) and A1 (bs 6) as BSRs, k = 1 and 8,
    float64 and float32 (the container cast by its ``astype``), against
    the plain versions (:func:`kernel_cases`: 1e-12 / 1e-5 relative, two
    K2 calls bitwise equal, CUDA events over a graph of 50 calls, median
    of 5, bound and cuSPARSE beside); then the CSR operator's time on the
    same matrix at each (dtype, k): phases 3b and 16's rows where they
    ran it, else timed here."""
    import torch

    from tpu_amg_torch.ops import spmv

    sa, el = trees["SA"], trees["elasticity"]
    sa_h, el_h = sa["csr"].hierarchy, el["csr"].hierarchy
    mats = {  # name -> (container, host CSR, the CSR's case name)
        "ELL SA A0": (sa["op"].mat, sa_h.matrices[0], "A0"),
        "ELL SA R0": (sa["pc"].levels[0].r.mat, sa_h.restrictions[0], "R0"),
        "BSR elasticity A0": (el["op"].mat, el_h.matrices[0],
                              "elasticity A0"),
        "BSR elasticity A1": (el["pc"].levels[1].a.mat, el_h.matrices[1],
                              "elasticity A1"),
    }
    t0 = time.perf_counter()
    dtypes = (torch.float64, torch.float32)
    out = {}
    for name, (mat, csr, csr_case) in mats.items():
        check(type(mat).__name__ == name.split()[0]
              and tuple(mat.shape) == csr.shape,
              f"phase 21 (a) {name}: a {type(mat).__name__} "
              f"{tuple(mat.shape)}, k {getattr(mat, 'k', None)}, block size "
              f"{getattr(mat, 'block_size', None)}")
        kernel_cases(name, {dt: mat.astype(dt).capped for dt in dtypes},
                     reps, results, KS_CONTAINER)
        own = spmv.CappedCSR.from_csr(csr, "cuda", torch.float64)
        say(f"phase 21 (a) {name}: its capped CSR is the CSR's own "
            f"(entries, order, tail): {same_capped(mat.capped, own)}; tail "
            f"{tail_shape(mat.capped)} against the CSR's {tail_shape(own)}")
        for dt in dtypes:
            dname = str(dt).replace("torch.", "")
            missing = [k for k in KS_CONTAINER
                       if not any(c["case"] == csr_case and c["k"] == k
                                  and c["dtype"] == dname for c in results)]
            if missing:
                kernel_cases(csr_case, {dt: own if dt == torch.float64 else
                                        spmv.CappedCSR.from_csr(csr, "cuda",
                                                                dt)},
                             reps, results, missing)
        out[name] = csr_case
    for name, csr_case in out.items():
        for c in results:
            if c["case"] != name:
                continue
            ref = next(r for r in results if r["case"] == csr_case
                       and r["k"] == c["k"] and r["dtype"] == c["dtype"])
            c["csr_k1_ms"], c["csr_k2_ms"] = ref["k1_ms"], ref["k2_ms"]
            say(f"phase 21 (a) {name} {c['dtype']} k={c['k']}: K1 "
                f"{c['k1_ms'] * 1e3:.2f} us against the CSR operator's "
                f"{ref['k1_ms'] * 1e3:.2f} (bound {c['k1_bound_ms'] * 1e3:.2f},"
                f" cuSPARSE {c['k1_lib_ms'] * 1e3:.2f}); K2 "
                f"{c['k2_ms'] * 1e3:.2f} us against the CSR's "
                f"{ref['k2_ms'] * 1e3:.2f}")
    say(f"phase 21 (a): {time.perf_counter() - t0:.1f} s")
    return out


def container_solves(trees) -> dict:
    """Phase 21 (b): each path's PCG of A x = A x_true (seeded) to RTOL,
    eager and compiled (a CUDA graph an iteration), over its containers
    and over its CSRs: the same iterations, x within CONTAINER_RTOL
    (bitwise printed), each pair eager = compiled bitwise; the counts set
    to 0 just before the container solves and read just after: every
    K1 and K2 launch there is a container's."""
    import torch

    from tpu_amg_torch.ops import spmv

    out = {}
    for label, limit in (("SA", MAX_ITERS), ("elasticity",
                                             MAX_ITERS_ELASTICITY)):
        tree = trees[label]
        t0 = time.perf_counter()
        csr_solver, c_solver = tree["csr"], tree["solver"]
        n = csr_solver.matrix.nrows
        x_true = torch.from_numpy(
            np.random.default_rng(100).standard_normal(n)).cuda()
        b = spmv.plain_spmv(csr_solver.op.mat, x_true)
        ref = eager_and_compiled(csr_solver, b, "cg", RTOL, 300)
        torch.cuda.synchronize()
        reset_counts()
        got = eager_and_compiled(c_solver, b, "cg", RTOL, 300)
        torch.cuda.synchronize()
        counts = shape_counts()
        say_shape_counts(f"phase 21 (b) {label} over containers", counts)
        check_same_solve(f"phase 21 (b) {label} over containers", got,
                         first=True)
        for (x, info, _), (xr, ir, _), how in zip(got, ref,
                                                  ("eager", "compiled")):
            rel = float((x - xr).abs().max() / xr.abs().max())
            check(info.converged and info.iters == ir.iters <= limit
                  and rel <= CONTAINER_RTOL,
                  f"phase 21 (b) {label} PCG {how}: over containers "
                  f"{info.iters} iterations, over CSRs {ir.iters} (limit "
                  f"{limit}); x rel diff {rel:.3e} (limit "
                  f"{CONTAINER_RTOL:.0e}), bitwise {torch.equal(x, xr)}")
        formats = tree["formats"]
        launched = {kernel: collections.Counter() for kernel in ("K1", "K2")}
        for kernel in launched:
            for (rows, cols, k), v in counts[kernel].items():
                launched[kernel][formats.get((rows, cols), "other")] += v
        check(launched["K1"]["other"] == launched["K2"]["other"] == 0
              and sum(launched["K1"].values()) > 0,
              f"phase 21 (b) {label}: every K1 and K2 launch of the "
              f"container solves on a container: K1 {dict(launched['K1'])}, "
              f"K2 {dict(launched['K2'])}")
        out[label] = dict(counts=counts, launched=launched,
                          iters=got[1][1].iters, seconds=time.perf_counter()
                          - t0)
        say(f"phase 21 (b) {label}: {out[label]['seconds']:.1f} s")
    return out


def sharded_containers(group, tree, csr_rec) -> dict:
    """Phase 21 (c), inside phase 19 (a)'s NCCL group of one rank: the SA
    solve over its containers sharded (``HaloELL`` at every sparse
    level), against phase 19's ``HaloCSR`` record: the same iterations,
    x within CONTAINER_RTOL; and ``shard_ell``'s all-gather form of the
    ELL A0 applied bitwise as the ELL itself."""
    import torch

    from tpu_amg_torch.parallel.dist import set_group, shard_ell

    t0 = time.perf_counter()
    rec = shard_record(tree["op"], tree["pc"], group, keep_x=True)
    check_shard_record("SA over ELLs", rec, DIST_RTOL_NCCL, ("K1",))
    rel = float((rec["x"] - csr_rec["x"]).abs().max()
                / csr_rec["x"].abs().max())
    check(rec["fine"] == "HaloELL" and rec["iters"] == csr_rec["iters"]
          and rel <= CONTAINER_RTOL,
          f"phase 21 (c) the SA solve sharded over ELLs: fine "
          f"{rec['fine']}, levels {rec['levels']}; {rec['iters']} iterations"
          f" against the HaloCSR solve's {csr_rec['iters']}, x rel diff "
          f"{rel:.3e} (limit {CONTAINER_RTOL:.0e}), bitwise "
          f"{torch.equal(rec['x'], csr_rec['x'])}")
    ell = tree["op"].mat
    x = torch.from_numpy(
        np.random.default_rng(5).standard_normal(ell.ncols)).cuda()
    with set_group(group):
        y = shard_ell(ell, group, "cuda").mv(x)
    same = torch.equal(y, ell.mv(x))
    check(same, f"phase 21 (c) shard_ell of the ELL A0 {ell.shape} at "
                f"{group.size} rank: applied bitwise as the ELL: {same}")
    rec["seconds"] = time.perf_counter() - t0
    say(f"phase 21 (c): {rec['seconds']:.1f} s")
    return rec


def container_entries(solves, sharded, results) -> list:
    """The kernels line's entries of phase 21: K1 and K2 on the ELL and
    the BSR containers (float64, k = 1), each beside the CSR operator's
    time on the same matrix; launches: (b)'s container solves at the
    container's shapes (and (c)'s sharded SA solve's, apart)."""
    out = []
    for fmt, kernel, key, case, replaces in (
            ("ELL", "K1", "k1", "ELL SA A0", "tpu_amg/ops/well_pallas.py:77"),
            ("ELL", "K2", "k2", "ELL SA R0", "tpu_amg/ops/well_pallas.py:457"),
            ("BSR", "K1", "k1", "BSR elasticity A0",
             "tpu_amg/ops/well_pallas.py:77"),
            ("BSR", "K2", "k2", "BSR elasticity A1",
             "tpu_amg/ops/well_pallas.py:457")):
        c = next(r for r in results if r["case"] == case
                 and r["dtype"] == "float64" and r["k"] == 1)
        mine = [r for r in results if r["case"].startswith(fmt + " ")
                and r["dtype"] == "float64"]
        name = ("csr_spmv_capped" if kernel == "K1" else "coo_patch")
        out.append(dict(
            name=f"{name}_{fmt.lower()}", route="cuda",
            source="tpu_amg_torch/csrc/spmv.cu", replaces=replaces,
            launches=sum(s["launched"][kernel][fmt] for s in solves.values()),
            max_abs_err=max(r[f"err{key[1]}"] for r in mine),
            ms=c[f"{key}_ms"], plain_ms=c[f"{key}_plain_ms"],
            bound_ms=c[f"{key}_bound_ms"], bound_by="bytes",
            library_ms=c[f"{key}_lib_ms"], case=case, rows=c["shape"][0],
            csr_ms=c[f"csr_{key}_ms"], container=fmt,
            launches_sharded=(sharded["launches"][kernel] if fmt == "ELL"
                              else None)))
    return out


# ---- phase 22: the SpMV throughput benchmark (tools.bench)

# (a) the entry point in-process at a small size
BENCH_SMALL_ARGV = ["--grid", "24", "--side", "128", "--reps", "10"]
# (c) the bf16-value applies against their plain versions: each value
# widens exactly to f32 and the sums run in f32, as the f32 applies'
BENCH_BF16_VALUES_TOL = TOL["float32"]
BENCH_CSR_ELL = 0.05  # "csr" against "ell": one capped CSR, K1 on both
# K3 (bf16, f32) on the structured A0 and K1 (f32, f32) on the FEM 1M as
# tools.bench applies them against the calls phases 15 and 10 timed on the
# same matrices, the two timed in turns (alternating_ms)
BENCH_READING = 0.10


def bench_library(mats: dict) -> dict:
    """The library's SpMV (a torch sparse CSR tensor ``@ x``) beside each
    timed apply of tools.bench: the same matrix as CSR, its values (bf16
    ones widened) in f32."""
    import torch

    out = {}
    for name in mats:
        base = mats["fem" if name.startswith("fem") else "csr"]
        vals = (base.data.to(torch.bfloat16) if name.endswith("bf16v")
                else base.data)
        out[name] = torch_csr(base.indptr, base.indices,
                              vals.to(torch.float32), base.shape)
    return out


def bench_phase(ps, fem_k1: dict, s_a0, k3_bf16_ms: float, reps: int, l2
                ) -> dict:
    """Phase 22: tools.bench, (a) its entry point at a small size, its
    counts read on their own; (b)
    :func:`tpu_amg_torch.tools.bench.measure` on phase 7's poisson3d(100)
    ``ps`` and phase 10's FEM 1M (``fem_k1``: its f32 CappedCSR, x and
    K1's time), the counts set to 0 just before (b) and read just after;
    (c) every timed apply against its plain version on ones and on a
    seeded x, timed beside it, the library's SpMV and its bound (over
    phase 11's L2 read rate ``l2`` where its bytes fit in L2), "csr"
    against "ell", and K3's (bf16, f32) and K1's FEM applies in turns with
    the calls that phase 15 (on the structured A0 ``s_a0`` in bf16,
    ``k3_bf16_ms``) and phase 10 timed on the same matrices.  Returns
    {"launches": (b)'s by kernel, "applies": (b)'s records by name}."""
    import contextlib
    import io

    import torch

    from tpu_amg_torch.ops import dia as dia_ops
    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.tools import bench
    from tpu_amg_torch.utils.timing import alternating_ms, median_ms

    def counts():
        torch.cuda.synchronize()
        return (dict(K1=spmv.csr_spmv_launches, K2=spmv.coo_patch_launches,
                     K3=dia_ops.dia_spmv_launches),
                dict(K1=dict(spmv.csr_spmv_launches_by_dtype),
                     K3=dict(dia_ops.dia_spmv_launches_by_dtype)))

    t_phase = time.perf_counter()
    fem_csr = fem_k1["mat"].to_csr()
    torch.cuda.synchronize()
    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.run(BENCH_SMALL_ARGV)
    small, _ = counts()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    nums = [line[k] for k in bench.KEYS if k not in ("metric", "unit")]
    check(list(line) == list(bench.KEYS)
          and all(np.isfinite(v) and v > 0 for v in nums)
          and small["K1"] > 0 and small["K3"] > 0 and small["K2"] == 0,
          f"phase 22 (a) python -m tpu_amg_torch.tools.bench "
          f"{' '.join(BENCH_SMALL_ARGV)}: its last line has bench.py's eight "
          f"keys, every number finite and > 0: {json.dumps(line)}; "
          f"launches K1 {small['K1']}, K2 {small['K2']}, K3 {small['K3']}")
    reset_counts()
    res = bench.measure(ps, fem_csr, "cuda", reps)
    launches, by_dtype = counts()
    rec = res["record"]
    say("phase 22 (b) tools.bench.measure on poisson3d("
        f"{STRUCTURED_SIDE}) and unstructured_fem_system({FEM_SIDE}), "
        f"--reps {reps}: its record on the next line")
    say(json.dumps(rec))
    nums = [res["json"][k] for k in bench.KEYS if k not in ("metric", "unit")]
    pair = (torch.bfloat16, torch.float32)
    check(all(np.isfinite(v) and v > 0 for v in nums)
          and launches["K1"] > 0 and launches["K3"] > 0
          and launches["K2"] == 0 and by_dtype["K1"].get(pair, 0) > 0
          and by_dtype["K3"].get(pair, 0) > 0
          and rec["poisson"]["tail_rows"] == rec["fem"]["tail_rows"] == 0,
          f"phase 22 (b): {json.dumps(res['json'])}; launches over (b): K1 "
          f"{launches['K1']}, K2 {launches['K2']} (no tail rows: poisson "
          f"{rec['poisson']['tail_rows']}, fem {rec['fem']['tail_rows']}), "
          f"K3 {launches['K3']}; at (bf16, f32) K1 "
          f"{by_dtype['K1'].get(pair, 0)}, K3 {by_dtype['K3'].get(pair, 0)}")

    # the many-column designs' tables on the 1M-row CSR matrices: their
    # host build (a part of from_csr's) and their device bytes
    for name in ("csr", "fem"):
        mat = res["matrices"][name]
        ip, ix = mat.indptr.cpu().numpy(), mat.indices.cpu().numpy()
        t0 = time.perf_counter()
        spmv.spmm_blocks(ip, ix)
        spmv.k2_pieces(mat.tail_ptr.cpu().numpy(),
                       mat.tail_row_ids.cpu().numpy())
        t_tables = time.perf_counter() - t0
        own = sum(t.numel() * t.element_size() for t in (
            mat.indptr, mat.indices, mat.data, mat.block_rows, mat.block_ptr))
        say(f"phase 22: {name} ({mat.shape[0]} rows, {mat.nnz} entries): "
            f"the many-column tables build in {t_tables:.2f} s on the host, "
            f"{mat.table_bytes() / 1e6:.1f} MB on the device beside the "
            f"capped CSR's {own / 1e6:.1f} MB ({mat.data.dtype} values; "
            f"{mat.n_spmm_blocks} staged-SpMM blocks, "
            f"{mat.spmm_cols.numel()} staged rows, "
            f"{mat.data.numel() / max(mat.spmm_cols.numel(), 1):.2f} "
            f"entries a staged row)")

    # (c) each timed apply against its plain version, and timed beside it
    libs = bench_library(res["matrices"])
    for name, mat in res["matrices"].items():
        g = torch.Generator(device="cuda").manual_seed(22)
        tol = (BENCH_BF16_VALUES_TOL if name.endswith("bf16v")
               else TOL["float32"])
        errs = []
        ones = torch.ones(mat.shape[1], device="cuda")
        for x in (ones,
                  torch.randn(mat.shape[1], generator=g, device="cuda")):
            y, p = bench.apply(mat, x), bench.plain_apply(mat, x)
            torch.cuda.synchronize()
            errs.append(float((y - p).abs().max())
                        / max(float(p.abs().max()), 1e-30))
        a = rec["applies"][name]
        a["max_rel_err"] = max(errs)
        a["plain_ms"] = median_ms(lambda: bench.plain_apply(mat, ones), reps,
                                  graph=True)
        a["library_ms"] = median_ms(lambda: libs[name] @ ones, reps,
                                    graph=True)
        a["bound_ms"] = pair_bound(a["bytes"], l2)
        check(max(errs) <= tol,
              f"phase 22 (c) {name} ({a['kernel']}, {type(mat).__name__} "
              f"{str(mat.dtype).replace('torch.', '')} values, f32 x): max "
              f"rel err on ones {errs[0]:.2e}, on a seeded x {errs[1]:.2e} "
              f"(limit {tol:.0e}); {a['ms'] * 1e3:.2f} us (plain "
              f"{a['plain_ms'] * 1e3:.2f}, library CSR @ x "
              f"{a['library_ms'] * 1e3:.2f}, bound "
              f"{a['bound_ms'] * 1e3:.2f}), {a['bytes']} B a call, "
              f"{a['gnnzs']:.1f} Gnnz/s")
    ms = {k: v["ms"] for k, v in rec["applies"].items()}
    check(abs(ms["ell"] / ms["csr"] - 1) <= BENCH_CSR_ELL,
          f"phase 22 (c): \"ell\" {ms['ell'] * 1e3:.2f} us against \"csr\" "
          f"{ms['csr'] * 1e3:.2f} us (limit {BENCH_CSR_ELL:.0%} apart: one "
          f"capped CSR)")
    # the earlier phases' calls on their own inputs (phase 15: the A0 in
    # bf16 and x from seed 1; phase 10: its x), in turns with tools.bench's
    a0_bf16 = s_a0.astype(torch.bfloat16)
    x15 = torch.randn(a0_bf16.shape[1], device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(1))
    for label, name, earlier, where, call in (
            ("K3 (bf16, f32) on the structured A0", "dia_bf16v", k3_bf16_ms,
             "phase 15", lambda: dia_ops.dia_spmv(a0_bf16, x15)),
            ("K1 (f32, f32) on the FEM 1M", "fem", fem_k1["k1_ms"],
             "phase 10", lambda: spmv.csr_spmv_capped(fem_k1["mat"],
                                                      fem_k1["x"]))):
        mat = res["matrices"][name]
        ones = torch.ones(mat.shape[1], device="cuda")
        a = rec["applies"][name]
        a["earlier_turns_ms"], a["turns_ms"] = alternating_ms(
            [call, lambda: bench.apply(mat, ones)], reps)
        check(abs(a["turns_ms"] / a["earlier_turns_ms"] - 1) <= BENCH_READING,
              f"phase 22 (c): {label}, tools.bench's apply "
              f"{a['turns_ms'] * 1e3:.2f} us in turns with {where}'s call "
              f"{a['earlier_turns_ms'] * 1e3:.2f} us (limit "
              f"{BENCH_READING:.0%} apart); (b) read {ms[name] * 1e3:.2f} "
              f"us, {where} {earlier * 1e3:.2f} us")
    say(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, applies=rec["applies"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # 48 keeps the whole run inside 900 s on the card beside phase 14's
    # 262,144-dof adaptive composite (PERF.md); 64 was the default before
    # phase 14
    ap.add_argument("--side", type=int, default=48,
                    help="the SA path's mesh side: side**3 dofs (48: "
                         "110,592; 64: 262,144; 101: 1.03M)")
    ap.add_argument("--elasticity-side", type=int, default=ELASTICITY_SIDE,
                    help="phase 16's mesh side: 3 * side**3 dofs (40: "
                         "192,000; 55: 499,125)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--dist-rank", metavar="CKPT", default=None,
                    help="run as one rank of phase 19 (b) on phase 4's "
                         "checkpoint (started by phase 19 itself)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    if args.dist_rank is not None:
        return dist_rank_main(args.dist_rank, args.side)

    from tpu_amg_torch.ops import (_build, dma, native, primitives, spmv,
                                   spmv_stages, stream)
    from tpu_amg_torch.ops import dia as dia_ops

    # ---- 1. device
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    say(smi)
    kind = torch.cuda.get_device_name(0)
    say(f"device: {kind}; torch {torch.__version__}; "
        f"CUDA {torch.version.cuda}; "
        f"nvcc {run([_build.nvcc_path(), '--version']).splitlines()[-1]}; "
        f"g++ {run(['g++', '-dumpfullversion'])}")

    # ---- 2. builds, from this checkout's sources
    builds = {
        "libamg_kernels.so (nvcc, sm_90a)": spmv.kernel_lib,
        "libamg_dia.so (nvcc, sm_90a)": dia_ops.kernel_lib,
        "libamg_stream.so (nvcc, sm_90a)": stream.kernel_lib,
        "libamg_stages.so (nvcc, sm_90a)": spmv_stages.kernel_lib,
        "libamg_dma.so (nvcc, sm_90a)": dma.kernel_lib,
        "libamg_primitives.so (nvcc, sm_90a)": primitives.kernel_lib,
        "libamg_native.so (g++)": native.lib,
    }
    for label in builds:
        (_build.BUILD_DIR / label.split()[0]).unlink(missing_ok=True)

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds) + 1) as pool:
        futures = {label: pool.submit(timed, fn) for label, fn in builds.items()}
        # ptxas's registers and spills of K3's kernels, beside the builds
        ptxas = pool.submit(_build.ptxas_report, dia_ops.SOURCE)
        build_s = {label: f.result() for label, f in futures.items()}
        dia_report = ptxas.result()
    say("build: " + "; ".join(f"{k} {v:.1f} s" for k, v in build_s.items())
        + f"; {time.perf_counter() - t0:.1f} s in all, side by side")
    check(say_row_registers(dia_report),
          "ptxas -v (csrc/dia.cu): K3's row-chunk kernel built at the five "
          "pairs, each k, R and C of its plans (R = 1 or 2 at k = 1; all "
          "k columns a thread or one at k = 2..7), none spilling")

    # the setups of phases 14 and 16-18 start now, beside phases 3-13
    with tempfile.TemporaryDirectory() as tmp:
        ckpts = {"classical": str(Path(tmp) / "classical.npz")}
        ckpts["dir"] = tmp
        pools, jobs = start_setup_jobs(args.elasticity_side, args.side,
                                       str(Path(tmp) / "elasticity.npz"),
                                       ckpts["classical"], tmp)
        try:
            kernels = drive(args, jobs, ckpts)
        finally:
            for pool in pools:
                pool.terminate()
                pool.join()
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
