"""The port's completeness, held by a test: every top-level public def and
class of fem_tpu has a counterpart in fem_tpu_torch, or is named below as
not carried, with its reason (ROADMAP.md, "Not carried, by design").

Both packages are read with `ast`; nothing of either is imported. A later
change that deletes a ported function, or adds a function to fem_tpu
without porting it, fails here until it names what it drops."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

# fem_tpu's "module:name" -> the port's "module:name" where the name or the
# module differs
MAPPED = {
    "ops/pallas_kernels.py:hex8_stiffness_pallas":
        "ops/cuda_kernels.py:hex8_stiffness",
    "ops/pallas_kernels.py:stencil_matvec_pallas":
        "ops/cuda_kernels.py:stencil_matvec",
    "ops/pallas_kernels.py:ell_matvec_pallas":
        "ops/cuda_kernels.py:csr_matvec",
    # the port's block_force takes the pre-gathered element displacements
    "ops/operator.py:block_force_un": "ops/operator.py:block_force",
    # grid-shaped u goes through the flat matvec as a view
    "ops/blockstencil.py:matvec_g": "ops/blockstencil.py:matvec",
    # flat wrappers of the grid transfers, which the port's cycle calls
    "solver/multigrid.py:prolong": "solver/multigrid.py:prolong_g",
    "solver/multigrid.py:restrict": "solver/multigrid.py:restrict_g",
}

_CM = "TPU-only layout: the component-major (*_cm) forms"
_ELL = "TPU-only layout: the ELL forms of the lattice GMG"
_STRUCT = ("TPU-only schedule: structured.matvec_{matmul,planes,planes27,"
           "pairs}; the port has K2's collapsed form")
_MG_HOST = "TPU-only schedule: the jitted and host-driven multigrid helpers"
_CG_HOST = "TPU-only schedule: cg.pcg_host* and *_chunked"
_JAXCACHE = "TPU-only: utils/jaxcache.py, the XLA compilation cache"
_IN_JIT = "auxiliary TPU workaround: direct.inv_in_jit / solve_in_jit"
_UNUSED = "unused: nothing in fem_tpu calls it"
_IR = ("measured slower on the H100: float32-inner MG-CG under float64 "
       "refinement 137.89 ms (107.85 at inner 1e-3) against the float64 "
       "solve's 75.43 ms on the 80^3 box")
_BLOCKS = ("unused layout: the slab row runs structured.matvec_sharded (u "
           "replicated), and shard_slabs cuts unequal slabs")
_PAD_ROWS = "unused layout: the halo block stencil takes unequal slabs"

NOT_CARRIED = {
    "ops/operator.py:matvec_cm": _CM,
    "ops/operator.py:matvec_ell": _CM,
    "ops/operator.py:matvec_rows": _CM,
    "ops/operator.py:matvec_segsum": _CM,
    "ops/blockstencil.py:matvec_cm": _CM,
    "parallel/halo_gather.py:to_padded_cm": _CM,
    "parallel/halo_gather.py:from_padded_cm": _CM,
    "parallel/halo_gather.py:matvec_cm_sharded": _CM,
    "solver/amg.py:v_cycle_cm": _CM,
    "solver/gmg.py:prolong_cm": _CM,
    "solver/gmg.py:restrict_cm": _CM,
    "solver/gmg.py:v_cycle_cm": _CM,
    "solver/gmg.py:GMGEllLevel": _ELL,
    "solver/gmg.py:GMGEllPrecond": _ELL,
    "solver/gmg.py:build_lattice_ell": _ELL,
    "solver/gmg.py:v_cycle_ell": _ELL,
    "ops/structured.py:matvec_matmul": _STRUCT,
    "ops/structured.py:matvec_planes": _STRUCT,
    "ops/structured.py:matvec_planes27": _STRUCT,
    "ops/structured.py:matvec_pairs": _STRUCT,
    "solver/multigrid.py:v_cycle_host": _MG_HOST,
    "solver/multigrid.py:v_cycle_host_sharded": _MG_HOST,
    "solver/multigrid.py:v_cycle_g": _MG_HOST + " (the grid entry that "
                                     "fem_tpu embeds in its jitted programs)",
    "solver/cg.py:pcg_host": _CG_HOST,
    "solver/cg.py:pcg_host_split": _CG_HOST,
    "solver/cg.py:pcg_chunked": _CG_HOST,
    "solver/cg.py:ir_pcg_chunked": _CG_HOST,
    "utils/jaxcache.py:enable": _JAXCACHE,
    "utils/jaxcache.py:host_fingerprint": _JAXCACHE,
    "solver/newton.py:solve_step_jit": "Newton: solve_step_jit and "
                                       "jit_newton, a TPU workaround",
    "solver/direct.py:inv_in_jit": _IN_JIT,
    "solver/direct.py:solve_in_jit": _IN_JIT,
    "solver/direct.py:solve": "auxiliary TPU workaround: the float64 LU "
                              "placed on the host CPU backend; the port "
                              "solves on the tensor's device",
    "ops/blockstencil.py:halo_masks": "auxiliary TPU workaround: eager "
                                      "masks for an in-jit bool cast "
                                      "miscompile",
    "parallel/halo_gather.py:device_put": "auxiliary: jax.device_put of the "
                                          "stacked tables; the port's build "
                                          "puts each shard's on its device",
    "solver/mixed.py:ir_solve": _IR,
    "solver/mixed.py:IRResult": _IR,
    "ops/structured.py:to_blocks": _BLOCKS,
    "ops/structured.py:from_blocks": _BLOCKS,
    "ops/structured.py:block_weights": _BLOCKS,
    "ops/structured.py:halo_matvec": _BLOCKS,
    "ops/structured.py:pad_for_devices": _BLOCKS,
    "ops/blockstencil.py:pad_rows": _PAD_ROWS,
    "ops/blockstencil.py:embed_rows_g": _PAD_ROWS,
    "io/native.py:morton_order": "unused: nothing in the port orders "
                                 "elements",
    "solver/gmg.py:preconditioner_g": _UNUSED,
    "ops/stiffness.py:element_stiffness_lame_batchlast_v2": _UNUSED,
    "ops/stiffness.py:internal_force_isotropic": _UNUSED,
}


def public_names(package):
    """{module path relative to the package: its top-level public def and
    class names}, read with ast."""
    root = ROOT / package
    out = {}
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        out[path.relative_to(root).as_posix()] = {
            node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef))
            and not node.name.startswith("_")}
    return out


JAX_NAMES = public_names("fem_tpu")
PORT_NAMES = public_names("fem_tpu_torch")


def split(key):
    module, name = key.split(":")
    return module, name


@pytest.mark.parametrize("module", sorted(JAX_NAMES))
def test_every_public_name_has_a_counterpart(module):
    """Each public name of the fem_tpu module is in the port module at the
    same relative path, or mapped to a port name that exists, or listed as
    not carried."""
    missing = []
    for name in sorted(JAX_NAMES[module]):
        key = f"{module}:{name}"
        if key in NOT_CARRIED:
            continue
        target = MAPPED.get(key, key)
        t_module, t_name = split(target)
        if t_name not in PORT_NAMES.get(t_module, set()):
            missing.append(f"{key} (looked for {target})")
    assert not missing, f"not in fem_tpu_torch and not listed: {missing}"


def test_listed_names_still_exist_in_fem_tpu():
    """Every MAPPED and NOT_CARRIED key names a public def or class that
    fem_tpu still has, every NOT_CARRIED entry has a reason, and no name
    the port carries under its own name is listed as not carried."""
    stale = [key for key in [*MAPPED, *NOT_CARRIED]
             if split(key)[1] not in JAX_NAMES.get(split(key)[0], set())]
    assert not stale, f"listed, but gone from fem_tpu: {stale}"
    assert all(reason.strip() for reason in NOT_CARRIED.values())
    carried = [key for key in NOT_CARRIED
               if split(key)[1] in PORT_NAMES.get(split(key)[0], set())]
    assert not carried, f"listed as not carried, but ported: {carried}"
    assert not set(MAPPED) & set(NOT_CARRIED)


def test_both_packages_were_read():
    """The parse saw both packages whole: fem_tpu's three Pallas kernels
    and the port's wrappers of their Hopper kernels."""
    assert {"hex8_stiffness_pallas", "stencil_matvec_pallas",
            "ell_matvec_pallas"} <= JAX_NAMES["ops/pallas_kernels.py"]
    assert {"stepper.py", "amg.py", "newton.py"} <= {
        m.split("/")[-1] for m in PORT_NAMES if m.startswith("solver/")}
    assert sum(map(len, JAX_NAMES.values())) > 150
