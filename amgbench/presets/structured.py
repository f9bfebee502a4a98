"""The structured path: ``build_structured_multigrid`` (factor-2
aggregation, DIA levels through K3, lazily smoothed transfers, Chebyshev
smoothers, a dense Cholesky coarse solve) inside ``AMGSolver``, whose
``solve`` replays one PCG iteration as a CUDA graph."""


def build(problem: dict, config: dict, device: str):
    import torch

    from tpu_amg_torch.solver import AMGSolver, SolverConfig
    from tpu_amg_torch.sparse.csr import CSR
    from tpu_amg_torch.structured import build_structured_multigrid

    dtype = getattr(torch, config["dtype"])
    n = len(problem["indptr"]) - 1
    a = CSR(data=problem["data"], indices=problem["indices"],
            indptr=problem["indptr"], shape=(n, n))
    mg = build_structured_multigrid(
        a, tuple(problem["grid"]), device=device,
        coarsest_dim=int(config["coarsest_dim"]), dtype=dtype)
    return AMGSolver(a, mg, config=SolverConfig(
        device=device, dtype=dtype, seed=int(config["setup_seed"])))
