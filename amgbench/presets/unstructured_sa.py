"""The smoothed-aggregation path of ``AMGSolver.setup`` with
``unstructured_config`` (the modularity partitioner, SA interpolation,
Chebyshev smoothers, dense levels at or under 8,192 rows), whose
``solve`` replays one PCG iteration as a CUDA graph."""


def build(problem: dict, config: dict, device: str):
    import torch

    from tpu_amg_torch.solver import AMGSolver, unstructured_config
    from tpu_amg_torch.sparse.csr import CSR

    n = len(problem["indptr"]) - 1
    a = CSR(data=problem["data"], indices=problem["indices"],
            indptr=problem["indptr"], shape=(n, n))
    return AMGSolver.setup(a, unstructured_config(
        device, dtype=getattr(torch, config["dtype"]),
        seed=int(config["setup_seed"])))
