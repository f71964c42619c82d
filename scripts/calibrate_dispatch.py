"""Fit the dispatcher's cost constants (ops/dispatch.COST) on this device.

    python scripts/calibrate_dispatch.py [--rehearse] [--out FILE.json]

In one process on the GPU, for each matrix and each backend whose model
finds it feasible, the backend's device pipeline is timed with its host
plan built outside the timed region (warm median of several runs,
block_until_ready). The grouped backend is timed in each of its table
modes (narrow and al-aligned), since the dispatcher prices all of them.
A backend is left untimed at a matrix only where the model, at the
constants in the tree, says it would take over MAX_MODEL_S; a backend
whose first timed run exceeds MAX_MEASURED_S keeps that one run.

Each backend's constants are then fitted to the FIT_POINTS times from the
same terms the estimators use (ops/dispatch.*_terms), by non-negative
least squares on relative error. Where a backend has fewer points than
free constants, the old constants' ratios are kept and only an overall
scale and the fixed cost are fitted. The HELD_OUT matrices are timed but
not fitted. The fitted table is kept only if ``choose_method`` picks at
least as well with it as with the tree's table on FIT_POINTS (geometric
mean of pick time over fastest time). Prints the fitted COST table, the
residual of every point, and for every matrix the backend
``choose_method`` picks against the one that measured fastest.
``--refit FILE.json`` redoes the fit and report from a saved run.

Exits 1 if any point failed: a failed point is printed as FAILED, kept
out of the fit, and recorded under "failed" in the JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

FIT_POINTS = (
    "poisson2d_256", "stencil27_32", "banded_16k", "er_small",
    "powerlaw_small", "pdb_8k", "dense_rows_2k", "dense_rows_8k",
    "er_medium", "circuit_64k", "powerlaw_medium", "econ_206k",
    "scircuit_256k", "webbase_1m",
)
HELD_OUT = ("mc2depi_524k", "fem_17k", "road_1m")
BACKENDS = ("chunked", "grouped", "tilepack", "dia", "bsr", "dense", "hash")
GROUPED_MODES = (0, 2, 4, 8)  # 0 = narrow, else the table alignment al
MAX_MODEL_S = 2.0
MAX_MEASURED_S = 2.0


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi not available"


def executor(method: str, a, al: int | None = None):
    """Zero-argument device call for one backend, plan built here (host)."""
    import jax

    if method == "chunked":
        from benchmark_spgemm_using_csr_tpu.ops.chunked import (
            make_chunked_plan, spgemm_chunked)
        plan = make_chunked_plan(a, a)
        return lambda: spgemm_chunked(a, a, plan)
    if method == "grouped":
        from benchmark_spgemm_using_csr_tpu.ops.grouped import (
            make_grouped_plan, spgemm_grouped)
        sched = make_grouped_plan(a, a, al=al)
        return None if sched is None else (lambda: spgemm_grouped(a, a, sched))
    if method == "tilepack":
        from benchmark_spgemm_using_csr_tpu.ops.tilepack import (
            make_tilepack_plan, spgemm_tilepack)
        sched = make_tilepack_plan(a, a)
        return None if sched is None else (lambda: spgemm_tilepack(a, a, sched))
    if method == "dia":
        from benchmark_spgemm_using_csr_tpu.ops.dia import dia_spgemm
        from benchmark_spgemm_using_csr_tpu.sparse.dia import DIA
        a_d = DIA.from_csr(a)
        fn = jax.jit(dia_spgemm)
        return lambda: fn(a_d, a_d)
    if method == "bsr":
        from benchmark_spgemm_using_csr_tpu.ops.bsr import (
            bsr_spgemm, make_bsr_plan)
        from benchmark_spgemm_using_csr_tpu.sparse.csr import BSR
        a_b = BSR.from_scipy(a.to_scipy(), block_shape=(8, 128))
        b_b = BSR.from_scipy(a.to_scipy(), block_shape=(128, 128))
        plan = make_bsr_plan(a_b, b_b)
        return lambda: bsr_spgemm(a_b, b_b, plan)
    if method == "dense":
        from benchmark_spgemm_using_csr_tpu.ops.dense import (
            make_dense_plan, spgemm_dense)
        plan = make_dense_plan(a, a)
        return lambda: spgemm_dense(a, a, plan)
    if method == "hash":
        from benchmark_spgemm_using_csr_tpu.ops.hash import spgemm_hash
        return lambda: spgemm_hash(a, a)
    raise ValueError(method)


def time_call(fn, runs: int) -> float:
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
        if ts[0] > MAX_MEASURED_S:
            break
    return float(np.median(ts))


def fit(rows: list[tuple[dict, float]], old: dict) -> dict:
    """Constants for one backend from (terms, seconds) rows."""
    from scipy.optimize import nnls

    from benchmark_spgemm_using_csr_tpu.ops.dispatch import price

    names = sorted({k for terms, _ in rows for k in terms})
    unit = {k: 1.0 if "FIXED_S" in k else 1e-9 for k in names}
    t = np.array([s for _, s in rows])
    x = np.array([[terms.get(k, 0.0) * unit[k] for k in names]
                  for terms, _ in rows])
    if len(rows) > len(names):
        coef, _ = nnls(x / t[:, None], np.ones(len(t)))
        return {k: float(c) for k, c in zip(names, coef)}
    # too few points: keep the old ratios among the variable terms, fit
    # one scale plus the fixed cost(s)
    fixed = [k for k in names if "FIXED_S" in k]
    var = [k for k in names if k not in fixed]
    prior = np.array([price({k: terms.get(k, 0.0) for k in var} if var
                            else {}) for terms, _ in rows])
    cols = [prior] + [x[:, names.index(k)] for k in fixed]
    coef, _ = nnls(np.stack(cols, 1) / t[:, None], np.ones(len(t)))
    out = {k: old[k] * float(coef[0]) for k in var}
    out.update({k: float(c) for k, c in zip(fixed, coef[1:])})
    return out


def candidates(D, a):
    """(label, method, grouped mode, terms) for every backend the model
    finds feasible; terms None = infeasible."""
    for method in BACKENDS:
        if method == "grouped":
            for al in GROUPED_MODES:
                yield f"grouped/al{al}", method, al, D.grouped_terms(a, a, al=al)
        else:
            yield method, method, None, getattr(D, f"{method}_terms")(a, a)


def stand_ins(g) -> dict:
    """Small matrices of the same generators, for a CPU rehearsal."""
    return {
        "poisson2d_256": lambda: g.poisson2d(32),
        "stencil27_32": lambda: g.stencil27(8),
        "banded_16k": lambda: g.banded(1024, bandwidth=12),
        "er_small": lambda: g.erdos_renyi(512, 512, 8.0),
        "powerlaw_small": lambda: g.power_law(512, 512, alpha=2.0,
                                              max_deg=64),
        "pdb_8k": lambda: g.fem(5, dof=3, fill=0.9, seed=5),
        "dense_rows_2k": lambda: g.dense_rows(256, 256, nnz_per_row=24),
        "dense_rows_8k": lambda: g.dense_rows(512, 512, nnz_per_row=48),
        "er_medium": lambda: g.erdos_renyi(2048, 2048, 12.0),
        "circuit_64k": lambda: g.circuit(2048),
        "powerlaw_medium": lambda: g.power_law(2048, 2048, alpha=2.0,
                                               max_deg=128),
        "econ_206k": lambda: g.erdos_renyi(3000, 3000, 6.0, seed=2),
        "scircuit_256k": lambda: g.circuit(4096),
        "webbase_1m": lambda: g.power_law(4096, 4096, alpha=2.0,
                                          max_deg=256, seed=1),
        "mc2depi_524k": lambda: g.poisson2d(48),
        "fem_17k": lambda: g.fem(6, dof=3, fill=0.7, seed=3),
        "road_1m": lambda: g.road_net(40, seed=13),
    }


def measure(args, D, suite) -> tuple[list[dict], list[tuple]]:
    """Time every candidate the model prices under MAX_MODEL_S. Returns
    (records, failures); a record holds matrix, backend label, method,
    terms and seconds (None = not timed)."""
    import jax

    from benchmark_spgemm_using_csr_tpu import CSR

    records, failed = [], []
    for name in FIT_POINTS + HELD_OUT:
        a = CSR.from_scipy(suite[name]())
        for label, method, al, terms in candidates(D, a):
            if terms is None:
                continue
            rec = dict(matrix=name, backend=label, method=method,
                       terms=terms, seconds=None)
            records.append(rec)
            if D.price(terms) > MAX_MODEL_S:
                print(f"  {name:16s} {label:12s} not timed: model "
                      f"{D.price(terms):.3f} s > {MAX_MODEL_S} s", flush=True)
                continue
            try:
                fn = executor(method, a, al)
                if fn is None:
                    records.pop()
                    continue
                rec["seconds"] = time_call(fn, args.runs)
            except Exception as e:  # noqa: BLE001 - recorded; exit code 1
                records.pop()
                failed.append((name, label, repr(e)[:300]))
                print(f"  {name:16s} {label:12s} FAILED: {e!r}"[:400],
                      flush=True)
                jax.clear_caches()
                continue
            print(f"  {name:16s} {label:12s} {rec['seconds'] * 1e3:10.3f} ms "
                  f"(model at the tree's constants "
                  f"{D.price(terms) * 1e3:9.3f} ms)", flush=True)
            jax.clear_caches()
    return records, failed


def picks(D, records: list[dict], cost: dict) -> dict:
    """Per matrix: (pick, measured fastest, time ratio). The pick is
    choose_method's: the cheapest candidate under ``cost``, with grouped's
    modes as separate candidates (make_grouped_plan runs the cheapest).
    The ratio is inf where the pick was not timed."""
    out = {}
    for name in dict.fromkeys(r["matrix"] for r in records):
        rows = [r for r in records if r["matrix"] == name]
        timed = {r["backend"]: r["seconds"] for r in rows
                 if r["seconds"] is not None}
        if not timed:
            continue
        pick = min(rows, key=lambda r: D.price(r["terms"], cost))["backend"]
        best = min(timed, key=timed.get)
        out[name] = (pick, best, timed.get(pick, np.inf) / timed[best])
    return out


def gmean_ratio(table: dict, names) -> float:
    r = [table[n][2] for n in names if n in table]
    return float(np.exp(np.mean(np.log(r)))) if r else 1.0


def analyse(D, records: list[dict], where: str) -> dict:
    """Fit, keep whichever of the tree's and the fitted constants picks
    better on FIT_POINTS, print the report; returns the kept table."""
    old = dict(D.COST)
    fitted = {}
    for method in BACKENDS:
        rows = [(r["terms"], r["seconds"]) for r in records
                if r["method"] == method and r["matrix"] in FIT_POINTS
                and r["seconds"] is not None]
        if rows:
            fitted.update(fit(rows, old))
    new = {k: fitted.get(k, old[k]) for k in old}

    # a better fit of the times can still pick worse: a backend whose
    # model form fits badly (chunked) can be priced under the fastest one
    score = {}
    for tag, cost in (("tree", old), ("fitted", new)):
        table = picks(D, records, cost)
        score[tag] = (gmean_ratio(table, FIT_POINTS),
                      gmean_ratio(table, HELD_OUT), table)
        print(f"\n{tag} constants: picks at {score[tag][0]:.3f}x of the "
              f"fastest (gmean, fit points), {score[tag][1]:.3f}x (held out)")
    keep = "fitted" if score["fitted"][0] <= score["tree"][0] else "tree"
    cost = new if keep == "fitted" else old
    print(f"kept: the {keep} constants")

    print(f"\n# fitted on {where}, {time.strftime('%Y-%m-%d')}"
          + ("" if keep == "fitted" else " (NOT kept: the tree's table "
             "picks better)"))
    print("COST = {")
    for k, v in new.items():
        tag = "" if k in fitted else "  # not calibrated: no feasible point"
        print(f'    "{k}": {v:.6g},{tag}')
    print("}")
    print(f"\nresiduals (model / measured - 1), {keep} constants:")
    for r in records:
        if r["seconds"] is None:
            continue
        held = "  (held out)" if r["matrix"] in HELD_OUT else ""
        print(f"  {r['matrix']:16s} {r['backend']:12s} "
              f"{D.price(r['terms'], cost) / r['seconds'] - 1:+.3f}{held}")
    print(f"\nper matrix, {keep} constants: choose_method's pick vs the "
          "measured fastest:")
    for name, (pick, best, ratio) in score[keep][2].items():
        held = "  (held out)" if name in HELD_OUT else ""
        shown = f"{ratio:.2f}x of fastest" if np.isfinite(ratio) else (
            "pick not timed")
        print(f"  {name:16s} pick {pick:12s} measured {best:12s} "
              f"({shown}){held}")
    return cost


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="small stand-in matrices on any device")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=None, help="write all points as JSON")
    ap.add_argument("--refit", default=None, metavar="FILE.json",
                    help="fit and report from a saved --out file; no timing")
    args = ap.parse_args()

    from benchmark_spgemm_using_csr_tpu.ops import dispatch as D

    failed = []
    if args.refit:
        with open(args.refit) as f:
            saved = json.load(f)
        where = saved["device"]
        records = [dict(r, method=r["backend"].split("/")[0])
                   for r in saved["points"] + saved["not_timed"]
                   if r.get("terms") is not None]
        failed = [tuple(x.values()) for x in saved["failed"]]
    else:
        import jax

        from benchmark_spgemm_using_csr_tpu.utils import generators as g
        from benchmark_spgemm_using_csr_tpu.utils.runtime import (
            init_compile_cache)

        dev = jax.devices()[0]
        if dev.platform != "gpu" and not args.rehearse:
            raise SystemExit(f"no GPU (default backend {dev.platform})")
        init_compile_cache()
        where = f"{dev.device_kind}, {card()}"
        print(f"device: {where}", flush=True)
        suite = dict(g.SUITE)
        if args.rehearse:
            suite.update(stand_ins(g))
        records, failed = measure(args, D, suite)

    cost = analyse(D, records, where)
    if failed:
        print(f"\nFAILED points ({len(failed)}):")
        for name, label, err in failed:
            print(f"  {name:16s} {label:12s} {err}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({
                "device": where, "cost": cost, "held_out": list(HELD_OUT),
                "points": [{k: r[k] for k in ("matrix", "backend", "seconds",
                                              "terms")}
                           for r in records if r["seconds"] is not None],
                "not_timed": [{"matrix": r["matrix"], "backend": r["backend"],
                               "terms": r["terms"],
                               "model_s": D.price(r["terms"])}
                              for r in records if r["seconds"] is None],
                "failed": [{"matrix": n, "backend": lab, "error": e}
                           for n, lab, e in failed],
            }, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
