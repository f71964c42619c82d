#!/usr/bin/env python3
"""Smoke run of the SpGEMM library on one GPU, through its public entry
points, with every result checked against the scipy oracle.

    python chip_smoke.py              # one GPU: float32 phases, then float64
    python chip_smoke.py --four       # four GPUs: the distributed phase only
    python chip_smoke.py --rehearse   # small sizes, any device, no contract

Phases (each prints the method, nnz(C), the oracle verdict with its
tolerance and precision, and informational compile and warm times beside
the card's name and power limit):

1. ``api.spgemm(method="auto")`` on generator matrices at real sizes;
2. every backend forced once, plus the out-of-core batched path, and a
   check that precision=HIGHEST keeps float32 matmuls off TF32;
3. the per-tile sort-merge at the tile shapes tilepack plans for
   er_medium and econ_206k, with ``memory_analysis()`` of the step;
4. float64 through ``api.spgemm`` against the x64 oracle (own process:
   x64 mode is process-wide);
5. AMG setup + V-cycle solve, ILU0, SpMV/SpMM and sparse add;
6. (``--four``) ``parallel.dist.dist_spgemm`` with the replicated, ring and
   halo schedules on a 4-GPU mesh against one card and scipy.

The parent process never imports JAX: it runs the phases as sequential
child processes, so only one process holds the card at a time. It exits
non-zero, and prints no contract line, unless JAX reports a GPU and every
phase passed. The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import traceback

RESULT_TAG = "CHIP_SMOKE_RESULT "
CHILD_TIMEOUT_S = {"f32": 780, "f64": 240, "four": 900}
F32_TOL = dict(rtol=1e-4, atol=1e-5)
F64_TOL = dict(rtol=1e-12, atol=1e-14)


def card_line() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else (
        "nvidia-smi not available"
    )


# --------------------------------------------------------------------------
# parent
# --------------------------------------------------------------------------


def run_child(phase: str, rehearse: bool, card: str) -> dict | None:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", phase]
    if rehearse:
        cmd.append("--rehearse")
    env = dict(os.environ, CHIP_SMOKE_CARD=card)
    if phase == "four" and rehearse:
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=4"
        ).strip()
    results: list[dict] = []
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    # the child's output is relayed by a thread, so a child that hangs
    # without printing is still killed at its deadline
    relay = threading.Thread(target=relay_lines, args=(proc.stdout, results),
                             daemon=True)
    relay.start()
    try:
        proc.wait(timeout=CHILD_TIMEOUT_S[phase])
    except subprocess.TimeoutExpired:
        print(f"phase {phase}: over {CHILD_TIMEOUT_S[phase]} s, killed",
              file=sys.stderr)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        relay.join(timeout=10)
    if proc.returncode != 0:
        print(f"phase {phase} failed: exit code {proc.returncode}",
              file=sys.stderr)
        return None
    return results[-1] if results else None


def relay_lines(stream, results: list) -> None:
    """Echo a child's lines; collect its tagged result lines."""
    for line in stream:
        if line.startswith(RESULT_TAG):
            results.append(json.loads(line[len(RESULT_TAG):]))
        else:
            sys.stdout.write(line)
            sys.stdout.flush()


def parent(args) -> int:
    card = card_line()
    print(f"card: {card}", flush=True)
    phases = ["four"] if args.four else ["f32", "f64"]
    device = None
    for phase in phases:
        res = run_child(phase, args.rehearse, card)
        if res is None or not res.get("ok"):
            return 1
        device = res["device"]
    if args.rehearse:
        print("rehearsal passed; a rehearsal prints no contract line")
        return 0
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


# --------------------------------------------------------------------------
# child: shared helpers
# --------------------------------------------------------------------------

CARD = os.environ.get("CHIP_SMOKE_CARD", "unknown card")
FAILED: list[str] = []


def say(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    """Run a phase body; a failure is printed and recorded, and the child
    then exits non-zero after the remaining phases."""

    def deco(fn):
        def run(*a, **kw):
            say(f"== {name}")
            try:
                fn(*a, **kw)
            except Exception:  # noqa: BLE001 - recorded, exit code set below
                FAILED.append(name)
                say(f"!! {name} FAILED")
                traceback.print_exc(file=sys.stdout)
                sys.stdout.flush()

        return run

    return deco


def timed(fn):
    """(result, first-call seconds incl. compile, warm seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn())
    t2 = time.perf_counter()
    return out, t1 - t0, t2 - t1


def report(label, method, c, ref, tol, precision, t_first, t_warm):
    """Check C against the oracle and print one verdict line."""
    import numpy as np

    from benchmark_spgemm_using_csr_tpu.utils.oracle import assert_csr_equal

    nnz_c = int(np.asarray(c.rowptr)[-1])
    assert_csr_equal(c, ref, **tol)
    say(
        f"  {label}: method={method} nnzC={nnz_c} verify=PASS "
        f"(rtol={tol['rtol']:g} atol={tol['atol']:g} {precision}) "
        f"first_call_s={t_first:.3f} (compile included) "
        f"warm_s={t_warm:.4f} [{CARD}]"
    )


def memory_line(tag: str) -> None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    keys = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
    say(f"  memory_stats {tag}: " + ", ".join(
        f"{k}={stats[k]}" for k in keys if k in stats
    ))


def matrices(rehearse: bool) -> dict:
    """Name -> scipy factory: the real generator suite, or small stand-ins
    of the same generators for a rehearsal."""
    from benchmark_spgemm_using_csr_tpu.utils import generators as g

    if not rehearse:
        return g.SUITE
    return {
        "webbase_1m": lambda: g.power_law(4096, 4096, alpha=2.0, max_deg=256,
                                          seed=1),
        "scircuit_256k": lambda: g.circuit(8192),
        "econ_206k": lambda: g.erdos_renyi(6000, 6000, 6.0, seed=2),
        "er_medium": lambda: g.erdos_renyi(4096, 4096, 12.0),
        "mc2depi_524k": lambda: g.poisson2d(48),
        "dense_rows_8k": lambda: g.dense_rows(512, 512, nnz_per_row=48),
        "powerlaw_medium": lambda: g.power_law(4096, 4096, alpha=2.0,
                                               max_deg=256),
        "circuit_64k": lambda: g.circuit(4096),
        "poisson2d_256": lambda: g.poisson2d(32),
        "banded_16k": lambda: g.banded(2048, bandwidth=12),
        "dense_rows_2k": lambda: g.dense_rows(256, 256, nnz_per_row=24),
        "er_small": lambda: g.erdos_renyi(1024, 1024, 8.0),
    }


# --------------------------------------------------------------------------
# child: phases
# --------------------------------------------------------------------------


def spgemm_case(label, a_sp, method, tol, dtype, precision):
    from benchmark_spgemm_using_csr_tpu import CSR, spgemm
    from benchmark_spgemm_using_csr_tpu.ops.dispatch import choose_method
    from benchmark_spgemm_using_csr_tpu.utils.oracle import spgemm_reference

    a = CSR.from_scipy(a_sp, dtype=dtype)
    chosen = choose_method(a, a) if method == "auto" else method
    c, t_first, t_warm = timed(lambda: spgemm(a, a, method=method))
    shown = f"auto->{chosen}" if method == "auto" else method
    report(label, shown, c, spgemm_reference(a, a), tol, precision,
           t_first, t_warm)


AUTO_CASES = ("webbase_1m", "scircuit_256k", "econ_206k", "er_medium",
              "mc2depi_524k", "dense_rows_8k")
FORCED_CASES = (
    ("chunked", "powerlaw_medium"),
    ("grouped", "circuit_64k"),
    ("tilepack", "er_medium"),
    ("dia", "poisson2d_256"),
    ("bsr", "banded_16k"),
    ("dense", "dense_rows_2k"),
    ("hash", "er_small"),
)


@phase("phase 1: auto dispatch at real sizes (float32)")
def phase_auto(mats):
    import numpy as np

    for name in AUTO_CASES:
        if name == "dense_rows_8k":
            memory_line("before dense_rows_8k")
        spgemm_case(name, mats[name](), "auto", F32_TOL, np.float32,
                    "float32")
        if name == "dense_rows_8k":
            memory_line("after dense_rows_8k")


@phase("phase 2: every backend forced once (float32)")
def phase_forced(mats):
    import numpy as np

    for method, name in FORCED_CASES:
        spgemm_case(f"{name}", mats[name](), method, F32_TOL, np.float32,
                    "float32")
    batched_case(mats["dense_rows_8k"]())
    matmul_precision_check()


def batched_case(a_sp):
    """Out-of-core batched path, held to a quarter of the product stream
    so it runs several row blocks."""
    from benchmark_spgemm_using_csr_tpu import CSR
    from benchmark_spgemm_using_csr_tpu.api import spgemm_flops
    from benchmark_spgemm_using_csr_tpu.ops.batched import (
        _cached_plan,
        spgemm_batched,
    )
    from benchmark_spgemm_using_csr_tpu.utils.oracle import spgemm_reference

    a = CSR.from_scipy(a_sp)
    budget = max(spgemm_flops(a, a) // 2 // 4, 1)
    plan = _cached_plan(a, a, budget, None)
    memory_line("before batched")
    c, t_first, t_warm = timed(
        lambda: spgemm_batched(a, a, stream_budget=budget, as_scipy=False)
    )
    memory_line("after batched")
    report(f"batched ({len(plan.blocks)} blocks)", f"batched/{plan.method}",
           c, spgemm_reference(a, a), F32_TOL, "float32", t_first, t_warm)


def matmul_precision_check():
    """precision=HIGHEST must keep a float32 matmul at float32 accuracy
    (TF32 keeps ~3 decimal digits); DEFAULT is printed for contrast."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(0)
    x = rng.standard_normal((1024, 1024)).astype(np.float32)
    y = rng.standard_normal((1024, 1024)).astype(np.float32)
    want = x.astype(np.float64) @ y.astype(np.float64)
    errs = {}
    for prec in (jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT):
        got = np.asarray(jnp.dot(jnp.asarray(x), jnp.asarray(y),
                                 precision=prec))
        errs[prec.name] = float(np.abs(got - want).max() / np.abs(want).max())
    say(f"  matmul f32 max rel err: HIGHEST={errs['HIGHEST']:.2e} "
        f"DEFAULT={errs['DEFAULT']:.2e}")
    if errs["HIGHEST"] > 1e-5:
        raise AssertionError(f"HIGHEST matmul not float32-accurate: {errs}")


@phase("phase 3: tile_sort_merge at tilepack's real tile shapes")
def phase_kernels(mats):
    import jax

    from benchmark_spgemm_using_csr_tpu import CSR
    from benchmark_spgemm_using_csr_tpu.ops.sortmerge import tile_sort_merge
    from benchmark_spgemm_using_csr_tpu.ops.tilepack import (
        SENTINEL,
        make_tilepack_plan,
    )

    for name in ("er_medium", "econ_206k"):
        a = CSR.from_scipy(mats[name]())
        plan = make_tilepack_plan(a, a).plan
        key, val = random_tiles(plan, seed=len(name))
        kw = dict(sentinel=SENTINEL, wlr=plan.wlr_eff, cbits=plan.cbits)
        compiled = jax.jit(lambda k, v: tile_sort_merge(k, v, **kw)).lower(
            key, val).compile()
        say(f"  {name}: tiles={plan.t_cap} width={plan.w} "
            f"wlr={plan.wlr_eff} cbits={plan.cbits}")
        say(f"  memory_analysis: {compiled.memory_analysis()}")
        out, t_first, t_warm = timed(lambda: compiled(key, val))
        check_tiles(key, val, out, plan, rows=256)
        say(f"  {name}: tile_sort_merge vs numpy on 256 tiles PASS "
            f"(exact keys/positions/counts, rtol=1e-5 values, float32) "
            f"first_call_s={t_first:.3f} warm_s={t_warm:.4f} [{CARD}]")


def random_tiles(plan, seed: int):
    """Packed (local_row << cbits | col) tiles with the plan's shape and
    about two thirds of the lanes live."""
    import jax.numpy as jnp
    import numpy as np

    from benchmark_spgemm_using_csr_tpu.ops.tilepack import SENTINEL

    rng = np.random.default_rng(seed)
    shape = (plan.t_cap, plan.w)
    lr = rng.integers(0, plan.wlr_eff, size=shape)
    col = rng.integers(0, min(1 << plan.cbits, 4 * plan.w), size=shape)
    key = ((lr << plan.cbits) | col).astype(np.int32)
    key[rng.random(shape) < 0.33] = SENTINEL
    val = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(key), jnp.asarray(val)


def check_tiles(key, val, out, plan, rows: int):
    """Per-tile numpy reference on the first ``rows`` tiles."""
    import numpy as np

    from benchmark_spgemm_using_csr_tpu.ops.tilepack import SENTINEL

    key, val = np.asarray(key)[:rows], np.asarray(val)[:rows]
    okey, oval, pos, cnt = (np.asarray(x)[:rows] for x in out)
    for t in range(rows):
        live = key[t] < SENTINEL
        uk, inv = np.unique(key[t][live], return_inverse=True)
        uv = np.zeros(len(uk), np.float64)
        np.add.at(uv, inv, val[t][live])
        tails = pos[t] < plan.w
        order = np.argsort(pos[t][tails])
        np.testing.assert_array_equal(np.sort(pos[t][tails]),
                                      np.arange(len(uk)))
        np.testing.assert_array_equal(okey[t][tails][order], uk)
        np.testing.assert_allclose(oval[t][tails][order], uv, rtol=1e-5,
                                   atol=1e-5)
        want_cnt = np.bincount(uk >> plan.cbits, minlength=plan.wlr_eff)
        np.testing.assert_array_equal(cnt[t], want_cnt[: plan.wlr_eff])


@phase("phase 4: float64 through api.spgemm (x64 oracle)")
def phase_f64(mats):
    import numpy as np

    for name in ("econ_206k", "poisson2d_256"):
        spgemm_case(name, mats[name]().astype(np.float64), "auto", F64_TOL,
                    np.float64, "float64")


@phase("phase 5: AMG, ILU0, SpMV/SpMM, sparse add")
def phase_ops(mats, rehearse: bool):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from benchmark_spgemm_using_csr_tpu import CSR
    from benchmark_spgemm_using_csr_tpu.models import amg, ilu0
    from benchmark_spgemm_using_csr_tpu.ops.spadd import spadd
    from benchmark_spgemm_using_csr_tpu.ops.spmv import spmm, spmv
    from benchmark_spgemm_using_csr_tpu.sparse.csr import csr_transpose
    from benchmark_spgemm_using_csr_tpu.utils import generators
    from benchmark_spgemm_using_csr_tpu.utils.oracle import assert_csr_equal

    rng = np.random.default_rng(0)
    p_sp = mats["poisson2d_256"]()
    b = rng.standard_normal(p_sp.shape[0]).astype(np.float32)
    t0 = time.perf_counter()
    x, hist = amg.solve(p_sp, b, tol=1e-5, max_iters=60)
    t_amg = time.perf_counter() - t0
    true_res = float(np.linalg.norm(b - p_sp @ x) / np.linalg.norm(b))
    if true_res >= 1e-4:
        raise AssertionError(f"AMG V-cycle solve residual {true_res:.2e}")
    say(f"  amg poisson2d ({p_sp.shape[0]} rows): {len(hist)} V-cycles, "
        f"true rel residual {true_res:.2e} < 1e-4 (float32) "
        f"wall_s={t_amg:.3f} (setup + compile included) [{CARD}]")

    k = 32 if rehearse else 128
    i_sp = generators.poisson2d(k)
    a_i = CSR.from_scipy(i_sp)
    f, t_first, t_warm = timed(lambda: ilu0.ilu0(a_i, sweeps=30))
    res = ilu0.ilu0_residual_on_pattern(a_i, f)
    if res >= 1e-4:
        raise AssertionError(f"ILU0 |LU - A| on pattern {res:.2e}")
    say(f"  ilu0 poisson2d ({i_sp.shape[0]} rows): max |LU-A| on pattern "
        f"{res:.2e} < 1e-4 (float32) first_call_s={t_first:.3f} "
        f"warm_s={t_warm:.4f} [{CARD}]")

    s_sp = mats["scircuit_256k"]()
    a = CSR.from_scipy(s_sp)
    xv = rng.standard_normal(s_sp.shape[1]).astype(np.float32)
    xm = rng.standard_normal((s_sp.shape[1], 64)).astype(np.float32)
    for label, fn, want in (
        ("spmv", lambda: spmv(a, jnp.asarray(xv)), s_sp @ xv),
        ("spmm k=64", lambda: spmm(a, jnp.asarray(xm)), s_sp @ xm),
    ):
        y, t_first, t_warm = timed(fn)
        np.testing.assert_allclose(np.asarray(y), want, rtol=1e-4, atol=1e-4)
        say(f"  {label} scircuit ({s_sp.shape[0]} rows): PASS vs scipy "
            f"(rtol=1e-4 atol=1e-4 float32) first_call_s={t_first:.3f} "
            f"warm_s={t_warm:.4f} [{CARD}]")

    e_sp = mats["econ_206k"]()
    a_e = CSR.from_scipy(e_sp)
    at = jax.block_until_ready(csr_transpose(a_e))
    c, t_first, t_warm = timed(lambda: spadd(a_e, at))
    assert_csr_equal(c, (e_sp + e_sp.T).tocsr(), **F32_TOL)
    nnz_c = int(np.asarray(c.rowptr)[-1])
    say(f"  spadd A+A^T econ ({e_sp.shape[0]} rows): nnzC={nnz_c} "
        f"verify=PASS (rtol=1e-4 atol=1e-5 float32) "
        f"first_call_s={t_first:.3f} warm_s={t_warm:.4f} [{CARD}]")


@phase("phase 6: dist_spgemm on a 4-device mesh")
def phase_four(mats):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from benchmark_spgemm_using_csr_tpu import CSR, spgemm
    from benchmark_spgemm_using_csr_tpu.parallel.dist import dist_spgemm
    from benchmark_spgemm_using_csr_tpu.utils.oracle import spgemm_reference

    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"need 4 devices, have {len(devs)}")
    mesh = Mesh(np.array(devs[:4]), ("rows",))
    say(f"  mesh: 4 x {devs[0].device_kind}, axis ('rows',), halo exchange: "
        "padded all_to_all")
    a = CSR.from_scipy(mats["webbase_1m"]())
    ref = spgemm_reference(a, a)
    one, t_first, t_warm = timed(lambda: spgemm(a, a))
    report("one card", "auto", one, ref, F32_TOL, "float32", t_first,
           t_warm)
    one_sp = one.to_scipy()
    for schedule in ("replicated", "ring", "halo"):
        c, t_first, t_warm = timed(
            lambda: dist_spgemm(a, a, mesh, schedule=schedule)
        )
        report(f"{schedule} vs scipy", f"dist/{schedule}x4", c, ref,
               F32_TOL, "float32", t_first, t_warm)
        report(f"{schedule} vs one card", f"dist/{schedule}x4", c, one_sp,
               F32_TOL, "float32", t_first, t_warm)


def child(args) -> int:
    if args.child == "f64":
        import jax

        jax.config.update("jax_enable_x64", True)
    import jax

    from benchmark_spgemm_using_csr_tpu.utils.runtime import init_compile_cache

    devs = jax.devices()
    say(f"jax.devices(): {devs}")
    for d in devs:
        say(f"  device {d.id}: platform={d.platform} kind={d.device_kind}")
    if devs[0].platform != "gpu":
        if not args.rehearse:
            say(f"no GPU: JAX's default backend is {devs[0].platform}")
            return 2
        say("REHEARSAL: device check skipped, small sizes")
    say(f"compile cache: {init_compile_cache()}")
    mats = matrices(args.rehearse)
    if args.child == "four":
        phase_four(mats)
    elif args.child == "f64":
        phase_f64(mats)
    else:
        phase_auto(mats)
        phase_forced(mats)
        phase_kernels(mats)
        phase_ops(mats, args.rehearse)
    if FAILED:
        say(f"FAILED phases: {FAILED}")
        return 1
    d = devs[0]
    say(RESULT_TAG + json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devs)},
    }))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU distributed phase")
    ap.add_argument("--rehearse", action="store_true",
                    help="small sizes; skips only the device check and "
                    "never prints the contract line")
    ap.add_argument("--child", choices=["f32", "f64", "four"],
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args)
    return parent(args)


if __name__ == "__main__":
    sys.exit(main())
