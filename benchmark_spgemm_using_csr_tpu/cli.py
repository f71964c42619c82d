"""Benchmark CLI driver — the equivalent of the reference's
``SpGEMM_cuda/main.cpp`` / ``SpGEMM_opencl/main.cpp`` harness (SURVEY.md §3
component 1, §4 driver contract [R]).

Behavioral contract matched to the reference driver:

- argv: a ``.mtx`` path (symmetric storage expanded, pattern values
  synthesized) — or, since this environment has no SuiteSparse files, a
  ``suite:<name>`` synthetic matrix from ``utils.generators.SUITE``.
- B := A (the benchmark computes C = A @ A).
- warmup run(s), then N timed runs; mean and best reported.
- correctness check against the scipy golden (the stand-in for the
  reference's serial CPU SpGEMM + element-wise compare, SURVEY.md §6).
- prints m, n, nnzA, intermediate products (nnzCt), nnzC, time, GFlops
  (= 2*nnzCt/time), nnz/s — the reference's printout set.

Extras beyond the reference (flagged, not default): ``--json`` structured
output, ``--roofline`` per-stage speed-of-light accounting, ``--out``
JSONL results appending, ``--mesh N`` distributed run.

Runs on the GPU. Without one it exits with an error, unless the CPU was
asked for explicitly with ``JAX_PLATFORMS=cpu`` (tests, rehearsals).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="benchmark_spgemm_using_csr_tpu",
        description="CSR SpGEMM benchmark (C = A @ A) on the GPU",
    )
    p.add_argument(
        "matrix",
        help=".mtx file path, or suite:<name> synthetic "
        "(see utils.generators.SUITE), or gen:<kind>:<size> "
        "(kinds: poisson2d, er, powerlaw, banded)",
    )
    p.add_argument(
        "--op",
        default="spgemm",
        choices=["spgemm", "spmv", "spmm", "spadd", "sptrsv"],
        help="benchmarked operation (spgemm: C=A@A; spmv: y=A@x; "
        "spmm: Y=A@X with k=--spmm-k dense columns; "
        "spadd: C=A+A^T symmetrization; "
        "sptrsv: L x = b on tril(A) with a diagonal shift ensuring "
        "nonsingularity, level-scheduled exact solve)",
    )
    p.add_argument("--spmm-k", type=int, default=64)
    p.add_argument(
        "--method",
        default="auto",
        choices=["auto", "chunked", "grouped", "tilepack", "bsr", "dia",
                 "dense", "tiled", "fused", "esc", "binned", "hash"],
    )
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument(
        "--dtype", default="float32",
        choices=["float32", "bfloat16", "float64"],
        help="float64 enables jax x64 mode (grouped rides the double-word "
        "int32 transport; verify tightens to rtol 1e-12 vs the x64 scipy "
        "golden)",
    )
    p.add_argument("--no-verify", action="store_true", help="skip scipy golden check")
    p.add_argument("--json", action="store_true", help="emit one JSON line instead of text")
    p.add_argument("--roofline", action="store_true", help="per-stage speed-of-light report")
    p.add_argument("--out", default=None, help="append a JSONL record to this path")
    p.add_argument(
        "--mesh",
        type=int,
        default=0,
        metavar="N",
        help="run distributed over an N-device mesh (0 = single device)",
    )
    p.add_argument(
        "--schedule",
        default="replicated",
        choices=["replicated", "ring", "halo"],
        help="distributed schedule (with --mesh)",
    )
    p.add_argument(
        "--ring-hop",
        type=int,
        default=None,
        metavar="H",
        help="ring schedule: B blocks per resident super-buffer (must "
        "divide the mesh size; default P//4 at P>=8 — H x resident-B "
        "memory for 1/H of the per-hop schedule overhead)",
    )
    p.add_argument(
        "--multihost",
        action="store_true",
        help="initialize the multi-host runtime (jax.distributed) before "
        "building the mesh; topology from --coordinator/--num-processes/"
        "--process-id or COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID env "
        "vars (all omitted = JAX's cluster auto-detection). See "
        "parallel/bootstrap.py for the launch recipe.",
    )
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def load_matrix(spec: str, dtype):
    """Resolve a matrix spec: a .mtx path, suite:<name>, or gen:<kind>:<n>."""
    from .utils import generators
    from .utils.mtx import read_mtx

    if spec.startswith("suite:"):
        name = spec[len("suite:") :]
        if name not in generators.SUITE:
            raise SystemExit(
                f"unknown suite matrix {name!r}; have {sorted(generators.SUITE)}"
            )
        return generators.SUITE[name]().astype(dtype)
    if spec.startswith("gen:"):
        _, kind, size = spec.split(":", 2)
        n = int(size)
        if kind == "poisson2d":
            return generators.poisson2d(n, dtype=dtype)
        if kind == "er":
            return generators.erdos_renyi(n, n, 8.0, dtype=dtype)
        if kind == "powerlaw":
            return generators.power_law(n, n, alpha=2.0, max_deg=max(n // 16, 2), dtype=dtype)
        if kind == "banded":
            return generators.banded(n, bandwidth=12, dtype=dtype)
        raise SystemExit(f"unknown generator kind {kind!r}")
    return read_mtx(spec, dtype=dtype)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .utils.runtime import check_device, init_compile_cache

    init_compile_cache()
    if args.dtype == "float64":
        # must flip BEFORE any jax array is created (x64 truncates
        # otherwise); the reference computes FP64 end-to-end (SURVEY.md §8)
        import jax

        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    platform = check_device()
    np_dtype = {
        "float32": np.float32,
        "bfloat16": jnp.bfloat16,
        "float64": np.float64,
    }[args.dtype]

    from . import CSR, spgemm, spgemm_flops
    from .utils.timing import bench
    from .utils.oracle import spgemm_reference, assert_csr_equal

    a_sp = load_matrix(
        args.matrix, np.float64 if args.dtype == "float64" else np.float32
    )
    a = CSR.from_scipy(a_sp, dtype=np_dtype)
    m, n = a.shape
    nnz_a = int(np.asarray(a.rowptr)[-1])

    if args.op in ("spmv", "spmm"):
        return run_spmv_spmm(args, a, a_sp, nnz_a)
    if args.op == "spadd":
        return run_spadd(args, a, a_sp, nnz_a)
    if args.op == "sptrsv":
        return run_sptrsv(args, a_sp)

    flops = spgemm_flops(a, a)
    nnz_ct = flops // 2

    if args.mesh:
        import jax
        from jax.sharding import Mesh
        from .parallel.dist import dist_spgemm

        if args.multihost:
            from .parallel.bootstrap import init_multihost

            topo = init_multihost(
                args.coordinator, args.num_processes, args.process_id
            )
            print(
                f"multihost  : process {topo.process_id}/"
                f"{topo.process_count}, {topo.global_devices} global devices",
                file=sys.stderr,
            )
        devs = jax.devices()
        if len(devs) < args.mesh:
            raise SystemExit(
                f"--mesh {args.mesh} needs {args.mesh} {platform} devices, "
                f"have {len(devs)}"
            )
        mesh = Mesh(np.array(devs[: args.mesh]), ("rows",))
        run = lambda: dist_spgemm(
            a, a, mesh, schedule=args.schedule, ring_hop=args.ring_hop
        )
    else:
        run = lambda: spgemm(a, a, method=args.method, trim=False)

    c = run()
    nnz_c = int(np.asarray(c.rowptr)[-1])
    res = bench(run, name=args.matrix, warmup=args.warmup, runs=args.runs,
                flops=flops, nnz_out=nnz_c)

    verified = None
    if not args.no_verify:
        golden = spgemm_reference(a, a)
        tol = {
            "float32": dict(rtol=1e-4, atol=1e-5),
            "bfloat16": dict(rtol=2e-2, atol=1e-2),
            "float64": dict(rtol=1e-12, atol=1e-14),
        }[args.dtype]
        try:
            assert_csr_equal(c, golden, **tol)
            verified = True
        except AssertionError as e:
            verified = False
            print(f"VERIFY FAILED: {e}", file=sys.stderr)

    record = {
        "matrix": args.matrix,
        "method": args.method if not args.mesh else f"dist/{args.schedule}x{args.mesh}",
        "dtype": args.dtype,
        "m": m,
        "n": n,
        "nnz_a": nnz_a,
        "nnz_ct": int(nnz_ct),
        "nnz_c": nnz_c,
        "mean_s": res.mean_s,
        "min_s": res.min_s,
        "gflops": res.gflops,
        "gflops_best": res.gflops_best,
        "nnz_per_s": res.nnz_per_s,
        "verified": verified,
        "device": device_record(),
    }

    if args.out:
        from .utils.results import write_result

        write_result(args.out, record)

    if args.json:
        print(json.dumps(record))
    else:
        print(f"matrix     : {args.matrix}  ({m} x {n}, nnzA = {nnz_a})")
        print(f"method     : {record['method']}  dtype={args.dtype}")
        print(f"nnzCt      : {nnz_ct}  (intermediate products; flops = {flops})")
        print(f"nnzC       : {nnz_c}")
        print(f"time       : mean {res.mean_s * 1e3:.3f} ms   best {res.min_s * 1e3:.3f} ms  ({args.runs} runs)")
        print(f"GFlops     : mean {res.gflops:.4f}   best {res.gflops_best:.4f}")
        print(f"nnz/s      : {res.nnz_per_s:.3e}")
        if verified is not None:
            print(f"verify     : {'PASS' if verified else 'FAIL'} (vs scipy golden)")

    if args.roofline:
        from .utils.roofline import (
            chip_spec,
            roofline_report,
            spgemm_stage_models,
        )

        models = spgemm_stage_models(
            nnz_a=nnz_a,
            nnz_b=nnz_a,
            m=m,
            total_products=int(nnz_ct),
            nnz_c=nnz_c,
            itemsize={"float32": 4, "bfloat16": 2, "float64": 8}[args.dtype],
        )
        # the CPU has no peak table entry: bytes and flops only
        chip = None if platform == "cpu" else chip_spec()
        report = roofline_report(models, total_time_s=res.mean_s, chip=chip)
        print(json.dumps(report, indent=2, default=float))

    return 0 if verified in (True, None) else 1


def device_record() -> dict:
    """The device every printed result ran on."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def run_spadd(args, a, a_sp, nnz_a: int) -> int:
    """Benchmark C = A + A^T (symmetrization) vs the scipy golden."""
    from .ops.spadd import make_add_plan, spadd_planned
    from .sparse.csr import csr_transpose
    from .utils.oracle import assert_csr_equal
    from .utils.timing import bench

    m, n = a.shape
    if m != n:
        raise SystemExit("spadd demo (A + A^T) needs a square matrix")
    import jax

    at = jax.block_until_ready(csr_transpose(a))
    plan = make_add_plan(a, at)
    run = lambda: spadd_planned(a, at, plan)
    flops = nnz_a * 2  # one add per stream slot
    res = bench(run, name=args.matrix, warmup=args.warmup, runs=args.runs,
                flops=flops)
    verified = None
    if not args.no_verify:
        want = (a_sp + a_sp.T).tocsr()
        try:
            assert_csr_equal(run(), want, rtol=1e-3, atol=1e-3)
            verified = True
        except AssertionError:
            verified = False
            print("VERIFY FAILED (spadd)", file=sys.stderr)

    record = {
        "matrix": args.matrix,
        "op": args.op,
        "m": m,
        "n": n,
        "nnz_a": nnz_a,
        "mean_s": res.mean_s,
        "min_s": res.min_s,
        "gflops": res.gflops,
        "verified": verified,
        "device": device_record(),
    }
    if args.out:
        from .utils.results import write_result

        write_result(args.out, record)
    if args.json:
        print(json.dumps(record))
    else:
        print(f"{args.op}: {args.matrix} mean {res.mean_s*1e3:.3f} ms  "
              f"{res.gflops:.4f} GFlops  verify "
              f"{'PASS' if verified else ('skip' if verified is None else 'FAIL')}")
    return 0 if verified in (True, None) else 1


def run_sptrsv(args, a_sp) -> int:
    """Benchmark the exact level-scheduled triangular solve L x = b, where
    L = tril(A) with the diagonal shifted to ensure nonsingularity
    (row-sum dominance), vs scipy.sparse.linalg.spsolve_triangular."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from . import CSR
    from .ops.sptrsv import make_trsv_plan, sptrsv_planned
    from .utils.timing import bench

    m, n = a_sp.shape
    if m != n:
        raise SystemExit("sptrsv needs a square matrix")
    l_sp = sp.tril(a_sp.tocsr(), format="csr").astype(np.float32)
    shift = np.abs(l_sp).sum(axis=1).max() + 1.0
    l_sp = (l_sp + sp.identity(m, np.float32, format="csr") * shift).tocsr()
    nnz_l = l_sp.nnz
    a = CSR.from_scipy(l_sp)
    sched = make_trsv_plan(a, lower=True)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(m).astype(np.float32))
    run = lambda: sptrsv_planned(a, b, sched)
    flops = 2 * nnz_l
    res = bench(run, name=args.matrix, warmup=args.warmup, runs=args.runs,
                flops=flops)
    verified = None
    if not args.no_verify:
        from scipy.sparse.linalg import spsolve_triangular

        want = spsolve_triangular(l_sp, np.asarray(b), lower=True)
        verified = bool(np.allclose(np.asarray(run()), want, rtol=1e-3, atol=1e-3))
        if not verified:
            print("VERIFY FAILED (sptrsv)", file=sys.stderr)

    record = {
        "matrix": args.matrix,
        "op": args.op,
        "m": m,
        "n": n,
        "nnz_l": nnz_l,
        "n_levels": sched.plan.n_levels,
        "mean_s": res.mean_s,
        "min_s": res.min_s,
        "gflops": res.gflops,
        "verified": verified,
        "device": device_record(),
    }
    if args.out:
        from .utils.results import write_result

        write_result(args.out, record)
    if args.json:
        print(json.dumps(record))
    else:
        print(f"{args.op}: {args.matrix} ({m} rows, nnzL {nnz_l}, "
              f"{sched.plan.n_levels} levels) mean {res.mean_s*1e3:.3f} ms  "
              f"{res.gflops:.4f} GFlops  verify "
              f"{'PASS' if verified else ('skip' if verified is None else 'FAIL')}")
    return 0 if verified in (True, None) else 1


def run_spmv_spmm(args, a, a_sp, nnz_a: int) -> int:
    """Benchmark y = A @ x (spmv) or Y = A @ X (spmm) vs the scipy golden."""
    import jax.numpy as jnp

    from .ops.spmv import spmm as spmm_op, spmv as spmv_op
    from .utils.timing import bench

    m, n = a.shape
    rng = np.random.default_rng(0)
    if args.op == "spmv":
        x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        run = lambda: spmv_op(a, x)
        flops = 2 * nnz_a
        want = a_sp @ np.asarray(x)
    else:
        x = jnp.asarray(rng.standard_normal((n, args.spmm_k)).astype(np.float32))
        run = lambda: spmm_op(a, x)
        flops = 2 * nnz_a * args.spmm_k
        want = a_sp @ np.asarray(x)

    res = bench(run, name=args.matrix, warmup=args.warmup, runs=args.runs,
                flops=flops)
    verified = None
    if not args.no_verify:
        got = np.asarray(run())
        verified = bool(np.allclose(got, want, rtol=1e-3, atol=1e-3))
        if not verified:
            print("VERIFY FAILED (spmv/spmm)", file=sys.stderr)

    record = {
        "matrix": args.matrix,
        "op": args.op,
        "m": m,
        "n": n,
        "nnz_a": nnz_a,
        "mean_s": res.mean_s,
        "min_s": res.min_s,
        "gflops": res.gflops,
        "verified": verified,
        "device": device_record(),
    }
    if args.out:
        from .utils.results import write_result

        write_result(args.out, record)
    if args.json:
        print(json.dumps(record))
    else:
        print(f"{args.op}: {args.matrix} mean {res.mean_s*1e3:.3f} ms  "
              f"{res.gflops:.4f} GFlops  verify "
              f"{'PASS' if verified else ('skip' if verified is None else 'FAIL')}")
    return 0 if verified in (True, None) else 1


if __name__ == "__main__":
    sys.exit(main())
