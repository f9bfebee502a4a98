"""Randomized-SVD manufactured-solution accuracy test: the port of the
JAX package's ``examples/rand_svd_test.py``.

Equivalent of reference examples/rand_svd_test.rs:39-105:
A = U·diag(e^{-0.1 i})·Vᵀ (200×150, k=50); recover it with ``rand_svd``
(oversample 10, 2 subspace iterations); report the U/V subspace
alignments ‖U_refᵀU‖_F²/k, the σ-recovery ratio, and their product, the
combined score (≈1 expected).  Ω is a standard normal draw from a CPU
``torch.Generator`` seeded with ``--seed``.

Usage: python -m tpu_amg_torch.tools.rand_svd_test [--device cpu]
"""

import argparse

import numpy as np
import torch


def run(device="cuda", m=200, n=150, k=50, decay=0.1, seed=0) -> dict:
    """The manufactured test on ``device``: its alignments, σ ratio and
    combined score."""
    from tpu_amg_torch.decompositions import rand_svd
    from tpu_amg_torch.device import resolve_device
    from tpu_amg_torch.linop import DenseOperator

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    u_ref, _ = np.linalg.qr(rng.normal(size=(m, m)))
    v_ref, _ = np.linalg.qr(rng.normal(size=(n, n)))
    sigma = np.exp(-decay * np.arange(n))
    a = (u_ref[:, :n] * sigma) @ v_ref.T

    u, s, v = rand_svd(
        DenseOperator(mat=torch.from_numpy(a).to(dev)), k, oversample=10,
        subspace_iters=2, generator=torch.Generator().manual_seed(seed),
        device=dev,
    )
    u, s, v = (t.cpu().numpy() for t in (u, s, v))
    align_u = np.linalg.norm(u_ref[:, :k].T @ u) ** 2 / k
    align_v = np.linalg.norm(v_ref[:, :k].T @ v) ** 2 / k
    sigma_ratio = s.sum() / sigma[:k].sum()
    return dict(align_u=align_u, align_v=align_v, sigma_ratio=sigma_ratio,
                score=align_u * align_v * sigma_ratio)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    r = run(args.device, seed=args.seed)
    print(f"U subspace alignment: {r['align_u']:.6f}")
    print(f"V subspace alignment: {r['align_v']:.6f}")
    print(f"sigma recovery ratio: {r['sigma_ratio']:.6f}")
    print(f"combined score:       {r['score']:.6f}")
    return r


if __name__ == "__main__":
    main()
