"""Run the five BASELINE.json acceptance configs end-to-end and report
pass/fail.

    python -u scripts/acceptance.py [--small]

Configs (BASELINE.json:7-11), with generated stand-ins for the SuiteSparse
matrices:
 1. cant-regime FEM matrix (poisson2d), FP64, CPU, scipy-checked.
 2. webbase/economics regime (irregular short rows: ER), default device.
 3. AMG Galerkin R*A*P hierarchy on 2D Poisson + V-cycle solve.
 4. mouse_gene regime (dense-ish power-law, long rows) via the hash path.
 5. Row-partitioned distributed C=A*A with the halo and ring schedules on
    an 8-virtual-device CPU mesh.

Configs 1 and 5 run in child processes forced to the CPU, so they never
compete with this process for the GPU. chip_smoke.py covers FP64 and the
mesh on the GPU itself.
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def log_result(name, ok, seconds, detail=""):
    mark = "PASS" if ok else "FAIL"
    print(f"[{mark}] {name}  ({seconds:.1f}s)  {detail}")
    return ok


def config1_f64_cpu(small):
    """FP64 scipy-checked CPU run (subprocess for x64 mode)."""
    n = 24 if small else 64
    code = f"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np, sys
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
from benchmark_spgemm_using_csr_tpu import CSR, spgemm
from benchmark_spgemm_using_csr_tpu.utils import generators
from benchmark_spgemm_using_csr_tpu.utils.oracle import spgemm_reference, assert_csr_equal
a_sp = generators.poisson2d({n}).astype(np.float64)
a = CSR.from_scipy(a_sp)
c = spgemm(a, a, method="chunked")
assert str(c.vals.dtype) == "float64"
assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-12, atol=1e-12)
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    return out.returncode == 0 and "OK" in out.stdout


def config2_short_rows(small):
    from benchmark_spgemm_using_csr_tpu import CSR, make_chunked_plan, spgemm_chunked, spgemm_flops
    from benchmark_spgemm_using_csr_tpu.utils import generators
    from benchmark_spgemm_using_csr_tpu.utils.oracle import spgemm_reference, assert_csr_equal

    n = 2048 if small else 16384
    a = CSR.from_scipy(generators.erdos_renyi(n, n, 6.0, seed=2))
    plan = make_chunked_plan(a, a)
    c = spgemm_chunked(a, a, plan)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-3, atol=1e-3)
    return True


def config3_amg(small):
    from benchmark_spgemm_using_csr_tpu.models import amg
    from benchmark_spgemm_using_csr_tpu.utils import generators

    k = 24 if small else 64
    a_sp = generators.poisson2d(k)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a_sp.shape[0]).astype(np.float32)
    x, residuals = amg.solve(a_sp, b, tol=1e-5, max_iters=60)
    return residuals[-1] < 1e-4 * float(np.linalg.norm(b))


def config4_powerlaw_hash(small):
    from benchmark_spgemm_using_csr_tpu import CSR
    from benchmark_spgemm_using_csr_tpu.ops.hash import spgemm_hash
    from benchmark_spgemm_using_csr_tpu.utils import generators
    from benchmark_spgemm_using_csr_tpu.utils.oracle import spgemm_reference, assert_csr_equal

    n = 1024 if small else 4096
    a = CSR.from_scipy(generators.power_law(n, n, alpha=1.9, max_deg=n // 8, seed=4))
    c = spgemm_hash(a, a)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-3, atol=1e-3)
    return True


def config5_distributed(small):
    code = f"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
import jax
import numpy as np, sys
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
from jax.sharding import Mesh
from benchmark_spgemm_using_csr_tpu import CSR
from benchmark_spgemm_using_csr_tpu.parallel.dist import dist_spgemm
from benchmark_spgemm_using_csr_tpu.utils import generators
from benchmark_spgemm_using_csr_tpu.utils.oracle import spgemm_reference, assert_csr_equal
n = {512 if small else 2048}
a = CSR.from_scipy(generators.power_law(n, n, alpha=2.0, max_deg=n // 8, seed=5))
mesh = Mesh(np.array(jax.devices()[:8]), ("rows",))
for schedule in ("halo", "ring"):
    c = dist_spgemm(a, a, mesh, schedule=schedule)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-3, atol=1e-3)
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        print(out.stderr[-1500:])
    return out.returncode == 0 and "OK" in out.stdout


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="tiny shapes (CI mode)")
    args = ap.parse_args()

    configs = [
        ("1-f64-cpu-scipy-checked", config1_f64_cpu),
        ("2-short-rows", config2_short_rows),
        ("3-amg-galerkin-vcycle", config3_amg),
        ("4-powerlaw-hash-path", config4_powerlaw_hash),
        ("5-distributed-halo-ring", config5_distributed),
    ]
    ok_all = True
    for name, fn in configs:
        t0 = time.time()
        try:
            ok = fn(args.small)
        except Exception as e:  # noqa: BLE001
            ok = False
            print(f"  error: {type(e).__name__}: {str(e)[:300]}")
        ok_all &= log_result(name, ok, time.time() - t0)
    print("ACCEPTANCE:", "ALL PASS" if ok_all else "FAILURES")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
