"""Collective counting: the communication model of the sharded operators.

Port of `fem_tpu/parallel/commcount.py`. fem_tpu walks the jaxpr of a sharded
function for its psum / ppermute primitives; the port's collectives are the
functions of parallel/mesh.py, so `collectives` runs the function and
returns the calls they recorded meanwhile. Same output shape, so the
closed-form traffic model (fem_tpu's DESIGN.md §5b) is asserted the same
way, per K·u: one full-vector all-reduce on the element-sharded operator and
on the slab-sharded stencil; two node planes (neighbor_exchange) on the
block stencil's halo layout; four (B, pdim) bands on the halo-gather
operator.
"""

from fem_tpu_torch.parallel import mesh as mesh_mod


def collectives(fn, *args):
    """All (name, operand_shape, operand_bytes) collectives that fn(*args)
    issued, in order."""
    rec = []
    mesh_mod.recorders.append(rec)
    try:
        fn(*args)
    finally:
        mesh_mod.recorders.remove(rec)
    return rec


def summary(path_name, cols):
    """One printable line: per-collective count and byte totals."""
    agg = {}
    for nm, _, nb in cols:
        c, b = agg.get(nm, (0, 0))
        agg[nm] = (c + 1, b + nb)
    parts = [f"{nm} x{c} ({b} B)" for nm, (c, b) in sorted(agg.items())]
    return (f"[comm] {path_name}: " + (", ".join(parts) if parts
                                       else "no collectives"))
