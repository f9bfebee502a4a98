"""K1's and K2's two many-column designs side by side on the card.

For each matrix and each k of ``K_SWEEP`` (the k > 1 that the paths
launch: the SA bootstrap's 7 and 8, its ||E||_A estimate's 5,
elasticity's 11, the adaptive and classical paths' 63 and 64; and their
neighbours): K1's first SpMM design (``spmv.launch_first_spmm``) and
its staged design (``spmv.launch_staged_spmm``: X rows staged in shared
memory up to ``spmv.SPMM_STAGE_ROW`` bytes, else read through L1), timed
in turns (``alternating_ms``), bitwise equal, beside the design the
router picks (``spmv.k1_design``: the bytes of an X row and the
matrix's mean capped row length); K2's rows design
(``spmv.launch_coo_patch`` at ``k2_lanes``) and its piece design
(``spmv.launch_coo_pieces``), timed in turns, within the dtype's
tolerance of each other and of the plain version, two calls of each
bitwise equal.  Beside each: the each-once bound (``spmv.k1_bytes``
over the HBM data sheet's rate) and the bytes the first design gathers
(nnz·k·itemsize).  Then, by dtype, the sums over the cases of each
design and of the routed one, and the cases where the router's pick
was more than 3% slower than the other design.

Alone it builds SA-like matrices from the adaptive path's fine A,
``anisotropic_diffusion_2d(--side, epsilon=1e-3, theta=pi/6,
coefficient="random")``: A0, a smoothed aggregation P0 of 4 x 4
aggregates (damped Jacobi, omega 2/3), R0 = P0^T, A1 = R0 A0 P0, and R0
of 8 x 8 aggregates, whose rows (about 100 entries) pass the cap of 64.
``chip_smoke.py`` calls :func:`sweep` on the paths' own matrices.

Times are of the device: CUDA events around the replay of a CUDA graph
of ``--reps`` calls, the median of 5 replays, the designs in turns.  It
needs a CUDA device (exit code 2 without one).  Every launch here is
uncounted.

Usage: python -m tpu_amg_torch.tools.spmmsweep [--side 512] [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import scipy.sparse as sps
import torch

from tpu_amg_torch.ops import spmv
from tpu_amg_torch.utils.timing import alternating_ms, hbm_bound_ms

K_SWEEP = (2, 3, 5, 7, 8, 11, 16, 17, 32, 33, 63, 64)
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def sa_like(side: int, agg: int):
    """A0, P0, R0 and A1 of a smoothed aggregation of ``agg`` x ``agg``
    point aggregates on the adaptive path's fine A at ``side``, as scipy
    CSR matrices with sorted indices."""
    from tpu_amg_torch.utils.problems import anisotropic_diffusion_2d

    a = anisotropic_diffusion_2d(side, epsilon=1e-3, theta=np.pi / 6,
                                 coefficient="random")
    a0 = sps.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    i = np.arange(side * side)
    nc = -(-side // agg)
    tent = sps.csr_matrix((np.ones(len(i)), (i, (i // side) // agg * nc
                                             + (i % side) // agg)),
                          shape=(len(i), nc * nc))
    p0 = (tent - (2 / 3) * sps.diags(1 / a0.diagonal()) @ a0 @ tent).tocsr()
    r0 = p0.T.tocsr()
    a1 = (r0 @ a0 @ p0).tocsr()
    for m in (a0, p0, r0, a1):
        m.sort_indices()
    return dict(A0=a0, P0=p0, R0=r0, A1=a1)


def matrices(side: int, side3d: int = 0) -> dict:
    """name -> scipy CSR: the SA-like A0, P0, R0, A1 of 4 x 4 aggregates
    and the R0 of 8 x 8 (a tail past the cap); with ``side3d``, also the
    SA path's A0 (``unstructured_poisson_3d(side3d)``) and the elasticity
    path's (``unstructured_elasticity_3d(side3d)``)."""
    four = sa_like(side, 4)
    out = {**four, "R0 (8x8)": sa_like(side, 8)["R0"]}
    if side3d:
        from tpu_amg_torch.utils.problems import (unstructured_elasticity_3d,
                                                  unstructured_poisson_3d)

        for name, make in (("poisson3d A0", unstructured_poisson_3d),
                           ("elasticity A0", unstructured_elasticity_3d)):
            a = make(side3d)
            out[name] = sps.csr_matrix((a.data, a.indices, a.indptr),
                                       shape=a.shape)
    return out


def gather_bytes(mat, k: int, itemsize: int) -> int:
    """The bytes of X the first design gathers: a whole X row an entry."""
    return mat.data.numel() * k * itemsize


def _max_err(y, ref) -> float:
    scale = max(float(ref.abs().max()), 1.0)
    return float((y - ref).abs().max()) / scale


def case(name: str, mat, k: int, reps: int) -> dict:
    """Both designs of K1 and of K2 on ``mat`` at k columns: times in
    turns, the router's pick, the checks, the bound and the gather
    bytes."""
    dtype = mat.dtype
    g = torch.Generator(device=mat.device).manual_seed(k)
    x = torch.randn((mat.shape[1], k), generator=g, device=mat.device,
                    dtype=dtype)
    first = spmv.launch_first_spmm(mat, x)
    staged = spmv.launch_staged_spmm(mat, x)
    again = spmv.launch_staged_spmm(mat, x)
    plain = spmv.plain_csr_spmv_capped(mat, x)
    isz = x.element_size()
    rec = dict(matrix=name, dtype=str(dtype).replace("torch.", ""), k=k,
               shape=tuple(mat.shape), nnz=mat.data.numel(),
               tail=mat.n_tail, blocks=mat.n_spmm_blocks,
               width=mat.spmm_width, row_mean=mat.row_mean,
               k1_stage=k * isz <= spmv.SPMM_STAGE_ROW,
               k1_design=spmv.k1_design(k, isz, mat.row_mean))
    torch.cuda.synchronize()
    rec["k1_bitwise"] = bool(torch.equal(first, staged)
                             and torch.equal(staged, again))
    rec["k1_err"] = _max_err(staged, plain)
    rec["k1_first_ms"], rec["k1_staged_ms"] = alternating_ms(
        [lambda: spmv.launch_first_spmm(mat, x),
         lambda: spmv.launch_staged_spmm(mat, x)], reps)
    rec["k1_routed_ms"] = rec["k1_first_ms" if rec["k1_design"] == "first"
                              else "k1_staged_ms"]
    rec["k1_bound_ms"] = hbm_bound_ms(spmv.k1_bytes(mat, k, dtype))
    rec["k1_gather_bytes"] = gather_bytes(mat, k, isz)
    if mat.n_tail:
        lanes = spmv.k2_lanes(mat.n_tail_rows, k,
                              spmv.sm_count(x.device.index))
        y0 = torch.randn((mat.shape[0], k), generator=g, device=x.device,
                         dtype=dtype)
        rows, pieces, pieces2, ref = (y0.clone() for _ in range(4))
        spmv.launch_coo_patch(mat, x, rows, k, lanes)
        spmv.launch_coo_pieces(mat, x, pieces, k)
        spmv.launch_coo_pieces(mat, x, pieces2, k)
        spmv.plain_coo_patch(mat, x, ref)
        yz = torch.zeros_like(y0)
        torch.cuda.synchronize()
        rec["k2_bitwise_again"] = bool(torch.equal(pieces, pieces2))
        rec["k2_err_rows"] = _max_err(pieces, rows)
        rec["k2_err"] = _max_err(pieces, ref)
        rec["k2_rows_ms"], rec["k2_pieces_ms"] = alternating_ms(
            [lambda: spmv.launch_coo_patch(mat, x, yz, k, lanes),
             lambda: spmv.launch_coo_pieces(mat, x, yz, k)], reps)
    rec["ok"] = (rec["k1_bitwise"] and rec["k1_err"] <= TOL[dtype]
                 and (not mat.n_tail or (rec["k2_bitwise_again"]
                                         and rec["k2_err"] <= TOL[dtype]
                                         and rec["k2_err_rows"]
                                         <= TOL[dtype])))
    return rec


def line(rec: dict) -> str:
    out = (f"{rec['matrix']} {rec['dtype']} k={rec['k']} {rec['shape']} nnz "
           f"{rec['nnz']} (rows {rec['row_mean']:.1f} entries on average; "
           f"blocks {rec['blocks']}, widest {rec['width']}): "
           f"K1 first {rec['k1_first_ms'] * 1e3:.2f} us staged "
           f"{rec['k1_staged_ms'] * 1e3:.2f} us ("
           + ("X staged" if rec["k1_stage"] else "gather mode")
           + f"), routed {rec['k1_design']}; bound "
           f"{rec['k1_bound_ms'] * 1e3:.2f} us, gathers "
           f"{rec['k1_gather_bytes'] / 1e6:.1f} MB; bitwise "
           f"{rec['k1_bitwise']}, err {rec['k1_err']:.2e}")
    if rec["tail"]:
        out += (f"; K2 rows {rec['k2_rows_ms'] * 1e3:.2f} us pieces "
                f"{rec['k2_pieces_ms'] * 1e3:.2f} us, err against rows "
                f"{rec['k2_err_rows']:.2e}, plain {rec['k2_err']:.2e}, two "
                f"calls bitwise {rec['k2_bitwise_again']}")
    return out


def sweep(mats: dict, ks=K_SWEEP, reps: int = 20, say=print) -> list:
    """:func:`case` on every (name, CappedCSR) of ``mats`` at every k of
    ``ks``, one line each."""
    records = []
    for name, mat in mats.items():
        for k in ks:
            records.append(case(name, mat, k, reps))
            say(line(records[-1]))
    return records


def summary(records: list) -> dict:
    """Over ``records``: the sums of K1's first, staged and routed times
    and of K2's rows and pieces times (ms), and K1's cases whose routed
    design was more than 3% slower than the other one."""
    out = {key: sum(r[key] for r in records if key in r)
           for key in ("k1_first_ms", "k1_staged_ms", "k1_routed_ms",
                       "k2_rows_ms", "k2_pieces_ms")}
    out["k1_slower"] = [
        f"{r['matrix']} k={r['k']}" for r in records
        if r["k1_routed_ms"] > 1.03 * min(r["k1_first_ms"],
                                          r["k1_staged_ms"])]
    return out


def say_summary(dtype: str, s: dict) -> str:
    return (f"{dtype}: K1 summed over the cases, first {s['k1_first_ms']:.4f}"
            f" ms, staged {s['k1_staged_ms']:.4f}, routed "
            f"{s['k1_routed_ms']:.4f}; routed more than 3% slower than the "
            f"other design in {len(s['k1_slower'])} cases "
            f"({', '.join(s['k1_slower'])}); K2 rows {s['k2_rows_ms']:.4f}"
            f" ms, pieces {s['k2_pieces_ms']:.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=512)
    ap.add_argument("--side3d", type=int, default=40,
                    help="the 3-D SA and elasticity A0's side (0: none)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ks", type=int, nargs="*", default=list(K_SWEEP))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spmmsweep needs a CUDA device", file=sys.stderr)
        return 2
    from tpu_amg_torch.sparse.csr import CSR

    print(f"# {torch.cuda.get_device_name(0)}; side {args.side}, reps "
          f"{args.reps}")
    records = []
    for name, sp in matrices(args.side, args.side3d).items():
        for dtype in (torch.float64, torch.float32):
            mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cuda", dtype)
            records += sweep({name: mat}, args.ks, args.reps)
    for dtype in ("float64", "float32"):
        print("# " + say_summary(dtype, summary(
            [r for r in records if r["dtype"] == dtype])))
    print(json.dumps(dict(records=records)))
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
