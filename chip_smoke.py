"""Smoke run of fem_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from fem_tpu_torch/csrc (nvcc, sm_90a);
  3. kernel K1 (hex8 stiffness) against its plain torch version, float64 and
     float32, at 131,072 jittered elements and at the shapes the main path
     gives it, with both times;
  4. kernel K2 (stencil matvec) against its plain version on the 81^3 node
     grid and on (9, 7, 6), float64 and float32, with both times;
  5. the CLI on the elastic golden deck with --device cuda, checked against
     the golden numbers (u_y 0.05 / 0.10, nodal stress 105 / 245 / 0);
  6. a small hex box on the direct path (K1 assembles k_e), checked against
     the same run on the CPU;
  7. stepper.run on the 80^3 hex8 box (1,594,323 DOFs, float64) through the
     structured MG-CG path, with the true relative residual recomputed with
     K2's plain version, and the launch counts of that run;
  8. kernel K3 (ELL SpMV) against its plain version, float64 and float32,
     on a random table (n = 200,000, w = 81) and, in phase 9, on the real
     prolongation, restriction and ELL mid-level tables of the 526,848-DOF
     SA-AMG hierarchy, with both times and each table's padding;
  9. the permuted, jittered 55^3 hex8 box (526,848 DOFs, float64): host
     set-up phases (assemble_csr, amg.build with its level sizes, fused
     operator), then stepper.run through unstructured_amg_or_lattice_gmg_cg
     with SA-AMG, its launch counts, and the true relative residual
     recomputed with assemble_csr's matrix as a torch sparse CSR product;
 10. the same box in lex order through the block stencil and lattice GMG,
     with the same residual check.
The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
it, the script exits non-zero before printing any result.
"""

import json
import subprocess
import sys
import tempfile
import time


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def time_ms(torch, fn, reps):
    """Median CUDA-event time of fn() over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    import numpy as np

    from fem_tpu_torch import kernels_build
    from fem_tpu_torch.cli import main as cli_main
    from fem_tpu_torch.config import Config
    from fem_tpu_torch.io import meshgen, vtk
    from fem_tpu_torch.models.system import System
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.ops import operator, structured
    from fem_tpu_torch.ops.stiffness import lame
    from fem_tpu_torch.solver import amg, cg, stepper

    # float32 products in the plain versions run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {smi}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = kernels_build.build()
    kernels_build.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s "
          f"({lib_path.name})", flush=True)
    for line in lib_path.with_suffix(".so.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    summary = {}

    # 3. K1 against its plain version
    base = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=float)

    def k1_inputs(ne, dtype, seed=0):
        rng = np.random.default_rng(seed)
        ec = np.transpose(base[None] + 0.05 * rng.normal(size=(ne, 8, 3)),
                          (2, 1, 0))
        lam = rng.uniform(1, 2, ne)
        mu = rng.uniform(1, 2, ne)
        return [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=dev) for a in (ec, lam, mu)]

    def k1_case(args, tol, label):
        got = ck.hex8_stiffness(*args)
        ref = ck.hex8_stiffness_plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K1 {label}: non-finite")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        asym = float((got - got.transpose(0, 1)).abs().max()) / float(
            ref.abs().max())
        print(f"K1 {label}: max rel diff {rel:.3e} (tol {tol:.0e}), "
              f"asymmetry {asym:.3e}", flush=True)
        check(rel <= tol, f"K1 {label}: max rel diff {rel} > {tol}")
        return err

    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        name = str(dtype).split(".")[-1]
        args = k1_inputs(131072, dtype)
        err = k1_case(args, tol, f"{name} ne=131072")
        ms = time_ms(torch, lambda: ck.hex8_stiffness(*args), 20)
        plain_ms = time_ms(torch, lambda: ck.hex8_stiffness_plain(*args), 5)
        print(f"K1 {name} ne=131072: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms", flush=True)
        if dtype == torch.float64:
            summary["hex8_stiffness"] = (err, ms, plain_ms)
        k1_case(k1_inputs(300, dtype, seed=1), tol, f"{name} ne=300")
        # the structured build's reference pair: one cell, (lam, mu) = (1, 0)
        # and (0, 1)
        cell = torch.as_tensor(base / 80.0, dtype=dtype, device=dev)
        pair = [torch.stack([cell, cell]).permute(2, 1, 0).contiguous(),
                torch.tensor([1.0, 0.0], dtype=dtype, device=dev),
                torch.tensor([0.0, 1.0], dtype=dtype, device=dev)]
        k1_case(pair, tol, f"{name} ne=2 (k_lam/k_mu pair)")

    # 4. K2 against its plain version
    lam_s, mu_s = lame(torch.tensor(200e9, dtype=torch.float64),
                       torch.tensor(0.3, dtype=torch.float64))
    for shape, cells in (((81, 81, 81), (1 / 80,) * 3),
                         ((9, 7, 6), (0.1, 0.2, 0.15))):
        op64 = structured.build(cells, shape, lam_s, mu_s,
                                dtype=torch.float64, device=dev)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
            name = str(dtype).split(".")[-1]
            k = op64.k_ref.to(dtype).contiguous()
            rng = np.random.default_rng(0)
            u = torch.as_tensor(rng.standard_normal(op64.ndof), dtype=dtype,
                                device=dev)
            got = ck.stencil_matvec(k, u, shape)
            ref = ck.stencil_matvec_plain(k, u, shape)
            torch.cuda.synchronize()
            rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
            print(f"K2 {name} {shape}: rel norm diff {rel:.3e} (tol "
                  f"{tol:.0e})", flush=True)
            check(bool(torch.isfinite(got).all()), f"K2 {shape}: non-finite")
            check(rel <= tol, f"K2 {name} {shape}: rel diff {rel} > {tol}")
            if shape == (81, 81, 81):
                ms = time_ms(torch, lambda: ck.stencil_matvec(k, u, shape), 50)
                plain_ms = time_ms(
                    torch, lambda: ck.stencil_matvec_plain(k, u, shape), 10)
                print(f"K2 {name} {shape}: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms", flush=True)
                if dtype == torch.float64:
                    summary["stencil_matvec"] = (
                        float((got - ref).abs().max()), ms, plain_ms)

    # 5. CLI on the elastic golden deck, on the card
    deck = "examples/ref/SNES_test/elastic/elastic_test.inp"
    with tempfile.TemporaryDirectory() as tmp:
        rc = cli_main(["-f", deck, "--device", "cuda", "-q",
                       "-o", f"{tmp}/"])
        check(rc == 0, f"CLI exited {rc}")
        pts, stress, disp = vtk.read_fields(f"{tmp}/0_output_000000.vtk")
    for y, uy in ((2.0, 0.1), (1.0, 0.05)):
        rows = pts[:, 1] == y
        check(np.allclose(disp[rows, 1], uy, atol=1e-12),
              f"golden u_y at y={y}: {disp[rows, 1]}")
    check(np.allclose(stress[:, :2], [105.0, 245.0], atol=1e-6)
          and np.allclose(stress[:, 2], 0.0, atol=1e-6),
          f"golden stress: {stress}")
    print("CLI elastic golden on cuda: u_y 0.05/0.10, stress 105/245/0 ok",
          flush=True)

    # 6. small hex box, direct path: K1 assembles k_e
    box = meshgen.hex_box_problem(6, 6, 6, lx=1.0, ly=1.0, lz=1.0)
    ck.reset_launches()
    r_gpu = stepper.run(box, Config(device="cuda"))
    k1_direct = ck.launches["hex8_stiffness"]
    r_cpu = stepper.run(box, Config(device="cpu"))
    rel = float(np.abs(r_gpu.aggregate_u - r_cpu.aggregate_u).max()
                / np.abs(r_cpu.aggregate_u).max())
    print(f"direct hex box 6^3 ({box.ndof} DOFs, path {r_gpu.path}): "
          f"K1 launches {k1_direct}, rel diff vs CPU {rel:.3e}", flush=True)
    check(r_gpu.path == "direct", f"expected the direct path, got {r_gpu.path}")
    check(k1_direct > 0, "the direct path launched no K1")
    check(rel <= 1e-9, f"direct hex box: GPU vs CPU rel diff {rel}")

    # 7. the 80^3 structured solve
    big = meshgen.hex_box_problem(80, 80, 80, lx=1.0, ly=1.0, lz=1.0,
                                  E=200e9, nu=0.3, tip_load=-1e6)
    check(big.ndof == 1594323, f"80^3 box has {big.ndof} DOFs")
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    res = stepper.run(big, Config(device="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.launches)
    check(res.path == "structured_mg_cg", f"80^3 box took path {res.path}")
    u = torch.as_tensor(res.aggregate_u, dtype=torch.float64, device=dev)
    check(bool(torch.isfinite(u).all()), "80^3 solution is not finite")
    check(res.aggregate_stress.shape == (big.nnds, 6)
          and bool(np.isfinite(res.aggregate_stress).all()),
          "80^3 stress is not finite or has the wrong shape")
    # true residual of the masked system, with K2's plain version
    system = System(big, torch.float64, device=dev)
    spec = structured.detect(big)
    lam_b, mu_b = lame(torch.tensor(spec["E"], dtype=torch.float64),
                       torch.tensor(spec["nu"], dtype=torch.float64))
    op = structured.build(spec["cell_sizes"], spec["node_shape"], lam_b,
                          mu_b, dtype=torch.float64, device=dev)
    k_ref = op.k_ref.contiguous()

    def plain_k(v):
        return ck.stencil_matvec_plain(k_ref, v, op.shape)

    bc_mask = torch.zeros(big.ndof, dtype=torch.bool, device=dev)
    bc_mask[system.bc_dofs] = True
    b = cg.constrained_rhs(plain_k, system.rhs(0.0), bc_mask,
                           torch.zeros_like(u))
    r = b - cg.masked_operator(plain_k, bc_mask)(u)
    true_rel = float(torch.linalg.norm(r) / torch.linalg.norm(b))
    tip = float(u.reshape(-1, 3)[:, 2].min())
    print(f"80^3 box ({big.ndof} DOFs, float64): MG-CG iterations "
          f"{res.krylov_iters}, true rel residual {true_rel:.3e}, wall "
          f"{wall:.2f} s, min u_z {tip:.6e}, launches {launches}",
          flush=True)
    check(true_rel <= 1e-8, f"80^3 true relative residual {true_rel} > 1e-8")
    check(tip < 0.0, "80^3 box: the tip load did not deflect the tip down")
    for name in ("hex8_stiffness", "stencil_matvec"):
        check(launches[name] > 0, f"the 80^3 run launched no {name}")

    # 8. K3 against its plain version on a random table
    def k3_case(vals, cols, x, label, reps=50):
        """K3 against its plain version in float64 and float32; returns the
        float64 (max abs err, kernel ms, plain ms)."""
        w, n = vals.shape
        nnz = int((vals != 0).sum())
        print(f"K3 {label}: n {n}, w {w}, lanes {ck.ell_lanes(w)}, padding "
              f"{vals.numel() / max(nnz, 1):.3f} slots per nonzero",
              flush=True)
        out = None
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            name = str(dtype).split(".")[-1]
            v, xx = vals.to(dtype).contiguous(), x.to(dtype)
            got = ck.ell_matvec(v, cols, xx)
            ref = ck.ell_matvec_plain(v, cols, xx)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"K3 {label}: non-finite")
            err = float((got - ref).abs().max())
            rel = err / max(float(ref.abs().max()), 1e-300)
            check(rel <= tol, f"K3 {name} {label}: max rel diff {rel} > {tol}")
            ms = time_ms(torch, lambda: ck.ell_matvec(v, cols, xx), reps)
            plain_ms = time_ms(
                torch, lambda: ck.ell_matvec_plain(v, cols, xx), 10)
            print(f"K3 {name} {label}: max rel diff {rel:.3e} (tol "
                  f"{tol:.0e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
                  flush=True)
            if out is None:
                out = (err, ms, plain_ms)
        return out

    rng = np.random.default_rng(0)
    n_r = 200000
    k3_case(torch.as_tensor(rng.standard_normal((81, n_r)), device=dev),
            torch.as_tensor(rng.integers(0, n_r, (81, n_r)), dtype=torch.int32,
                            device=dev),
            torch.as_tensor(rng.standard_normal(n_r), device=dev),
            "random n=200000 w=81")

    # 9. the permuted 55^3 box: set-up phases, K3 on the real tables, and
    # stepper.run through SA-AMG
    def box55(permute):
        p = meshgen.hex_box_problem(55, 55, 55, lx=1.0, ly=1.0, lz=1.0,
                                    E=200e9, nu=0.3, tip_load=-1e6,
                                    jitter=0.25, seed=0)
        p = meshgen.permute_nodes(p, seed=0) if permute else p
        check(p.ndof == 526848, f"55^3 box has {p.ndof} DOFs")
        return p

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def true_rel_residual(system, A_csr, u):
        """||b - K u|| / ||b|| of the masked system, K from assemble_csr as
        a torch sparse CSR product on the card (a check, not the path)."""
        K = torch.sparse_csr_tensor(
            torch.as_tensor(A_csr.indptr, dtype=torch.int64, device=dev),
            torch.as_tensor(A_csr.indices, dtype=torch.int64, device=dev),
            torch.as_tensor(A_csr.data, dtype=torch.float64, device=dev),
            size=A_csr.shape, check_invariants=True)

        def kmv(v):
            return (K @ v.unsqueeze(1)).squeeze(1)

        mask = torch.zeros(system.ndof, dtype=torch.bool, device=dev)
        mask[system.bc_dofs] = True
        b = cg.constrained_rhs(kmv, system.rhs(0.0), mask, torch.zeros_like(u))
        r = b - cg.masked_operator(kmv, mask)(u)
        return float(torch.linalg.norm(r) / torch.linalg.norm(b))

    perm = box55(permute=True)
    system, t_sys = timed(lambda: System(perm, torch.float64, device=dev))
    A_csr, t_asm = timed(lambda: amg.assemble_csr(system))
    hier, t_amg = timed(lambda: amg.build(system, system.bc_dofs,
                                          coarse_max=20000, A=A_csr))
    _, t_op = timed(lambda: operator.build(system))
    sizes = [system.ndof] + [lv.n_coarse for lv in hier.levels[:-1]]
    print(f"permuted 55^3 box ({perm.ndof} DOFs) set-up on the host: System "
          f"{t_sys:.2f} s, assemble_csr {t_asm:.2f} s ({A_csr.nnz} nonzeros), "
          f"amg.build {t_amg:.2f} s (level sizes {sizes}), fused operator "
          f"{t_op:.2f} s", flush=True)
    k3_real = None
    for i, lv in enumerate(hier.levels[:-1]):
        n_f = lv.dinv.shape[0]
        tables = [("P", lv.P, lv.n_coarse), ("R", lv.R, n_f)]
        if lv.op is not None:
            tables.append(("A (ELL mid level)", lv.op, n_f))
        for name, e, nx in tables:
            x = torch.as_tensor(rng.standard_normal(nx), device=dev)
            res_k3 = k3_case(e.vals, e.cols, x, f"level {i} {name}")
            if i == 0 and name == "P":
                k3_real = res_k3
    check(k3_real is not None, "the 55^3 hierarchy has no transfer level")
    del hier

    ck.reset_launches()
    msgs = []
    res, wall = timed(lambda: stepper.run(perm, Config(device="cuda"),
                                          log=msgs.append))
    launches_amg = dict(ck.launches)
    for m in msgs:
        if "Interval" not in m:
            print(f"  stepper: {m.strip()}")
    check(res.path == "unstructured_amg_or_lattice_gmg_cg",
          f"permuted 55^3 box took path {res.path}")
    check(any("smoothed aggregation" in m for m in msgs)
          and not any("Lattice topology" in m or "lattice-MG" in m
                      for m in msgs),
          "the permuted 55^3 box did not take the fused operator and SA-AMG")
    u = torch.as_tensor(res.aggregate_u, device=dev)
    check(bool(torch.isfinite(u).all())
          and res.aggregate_stress.shape == (perm.nnds, 6)
          and bool(np.isfinite(res.aggregate_stress).all()),
          "permuted 55^3 solution or stress not finite / wrong shape")
    true_rel = true_rel_residual(system, A_csr, u)
    print(f"permuted 55^3 box ({perm.ndof} DOFs, float64): SA-AMG-CG "
          f"iterations {res.krylov_iters}, true rel residual {true_rel:.3e}, "
          f"stepper.run wall {wall:.2f} s, min u_z "
          f"{float(u.reshape(-1, 3)[:, 2].min()):.6e}, launches "
          f"{launches_amg}", flush=True)
    check(true_rel <= 1e-8, f"permuted 55^3 true rel residual {true_rel}")
    for name in ("hex8_stiffness", "ell_matvec"):
        check(launches_amg[name] > 0, f"the SA-AMG run launched no {name}")
    del system, A_csr, u

    # 10. the lex-ordered 55^3 box: block stencil + lattice GMG
    lex = box55(permute=False)
    ck.reset_launches()
    msgs = []
    res, wall = timed(lambda: stepper.run(lex, Config(device="cuda"),
                                          log=msgs.append))
    launches_gmg = dict(ck.launches)
    for m in msgs:
        if "Interval" not in m:
            print(f"  stepper: {m.strip()}")
    check(res.path == "unstructured_amg_or_lattice_gmg_cg",
          f"lex 55^3 box took path {res.path}")
    check(any("Geometric lattice-MG" in m for m in msgs)
          and not any("demotion" in m for m in msgs),
          "the lex 55^3 box did not solve with lattice GMG")
    system = System(lex, torch.float64, device=dev)
    u = torch.as_tensor(res.aggregate_u, device=dev)
    check(bool(torch.isfinite(u).all())
          and bool(np.isfinite(res.aggregate_stress).all()),
          "lex 55^3 solution or stress not finite")
    true_rel = true_rel_residual(system, amg.assemble_csr(system), u)
    print(f"lex 55^3 box ({lex.ndof} DOFs, float64): GMG-CG iterations "
          f"{res.krylov_iters}, true rel residual {true_rel:.3e}, "
          f"stepper.run wall {wall:.2f} s, launches {launches_gmg}",
          flush=True)
    check(true_rel <= 1e-8, f"lex 55^3 true rel residual {true_rel}")
    check(launches_gmg["hex8_stiffness"] > 0, "the GMG run launched no K1")

    summary["ell_matvec"] = k3_real
    launches["ell_matvec"] = launches_amg["ell_matvec"]
    sources = {
        "hex8_stiffness": ("fem_tpu_torch/csrc/hex8_stiffness.cu",
                           "fem_tpu/ops/pallas_kernels.py:352"),
        "stencil_matvec": ("fem_tpu_torch/csrc/stencil_matvec.cu",
                           "fem_tpu/ops/pallas_kernels.py:302"),
        "ell_matvec": ("fem_tpu_torch/csrc/ell_matvec.cu",
                       "fem_tpu/ops/pallas_kernels.py:432"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": summary[name][0],
         "ms": summary[name][1], "plain_ms": summary[name][2]}
        for name, (src, rep) in sources.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
