"""The device mesh and its collectives.

Port of `fem_tpu/parallel/mesh.py`. The reference's parallelism is one-axis
domain decomposition over mesh elements via METIS + MPI (SURVEY.md §2c);
fem_tpu's is one logical mesh axis under `shard_map`. The port is
single-controller, as `shard_map` is: one process holds a list of per-shard
tensors, each on its shard's device, and the collectives fem_tpu takes from
`jax.lax` (`psum`, `ppermute`, a replicated or a sharded operand) are the
functions below, over such lists. They are the only places where data crosses
shards, and parallel/commcount.py records every call made while it listens.
A DOF-sharded vector is a ShardedVector: the list with the elementwise
arithmetic and the two reductions a Krylov loop or a smoother needs, so that
solver/cg.pcg and the multigrid cycles run on it as they run on a tensor.

`FEM_TPU_TORCH_VIRTUAL_DEVICES=N` in the environment is the counterpart of
XLA's `--xla_force_host_platform_device_count`: with it, up to N shards are
laid round-robin over the CUDA cards that exist, so that the sharded code
paths run on a machine with fewer cards than shards. Without it a mesh never
has more shards than cards. On the CPU every shard lies on the one CPU device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from fem_tpu_torch.config import resolve_device

VIRTUAL_ENV = "FEM_TPU_TORCH_VIRTUAL_DEVICES"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """1D mesh: the device of each shard, in shard order."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def cards(self) -> Tuple[torch.device, ...]:
        """The distinct devices, in order of first use."""
        return tuple(dict.fromkeys(self.devices))

    def describe(self) -> str:
        kind = "card(s)" if self.devices[0].type == "cuda" else "CPU device"
        return f"{self.size} shards on {len(self.cards)} {kind}"


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> DeviceMesh:
    """1D mesh of n_devices shards (default: one per available device).

    CUDA: shard i on card i, and asking for more shards than cards raises,
    unless FEM_TPU_TORCH_VIRTUAL_DEVICES allows as many shards; then shard i
    lies on card i mod the number of cards. CPU: every shard on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return DeviceMesh((dev,) * (n_devices or 1))
    n_cards = torch.cuda.device_count()
    available = max(n_cards, int(os.environ.get(VIRTUAL_ENV, "0") or 0))
    if n_devices is None:
        n_devices = n_cards
    if n_devices > available:
        raise ValueError(
            f"requested {n_devices} devices, only {available} available")
    return DeviceMesh(tuple(torch.device("cuda", i % n_cards)
                            for i in range(n_devices)))


def slab_bounds(n: int, nd: int) -> List[Tuple[int, int]]:
    """[start, end) of nd contiguous slabs of n planes (or cells): equal
    where nd divides n, else the first n mod nd slabs one longer, so that
    only with n < nd are there empty slabs, and those come last (fem_tpu pads
    n up to equal slabs instead)."""
    ends = [(n // nd) * i + min(i, n % nd) for i in range(nd + 1)]
    return list(zip(ends[:-1], ends[1:]))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

# the lists that commcount.collectives is recording into
recorders: List[list] = []


def _count(name: str, *operand: torch.Tensor) -> None:
    """Record a collective with its operand: one tensor (its shape), or the
    parts of a sharded vector (the whole's length)."""
    nbytes = sum(p.numel() * p.element_size() for p in operand)
    shape = (tuple(operand[0].shape) if len(operand) == 1
             else (sum(p.numel() for p in operand),))
    for rec in recorders:
        rec.append((name, shape, nbytes))


def all_reduce_sum(mesh: DeviceMesh, parts: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """Sum of one tensor per shard; returns the sum on every shard's device
    (one tensor per card, shared by the shards that lie on it). The parts are
    brought to shard 0's device and added in shard order, so the bits do not
    depend on timing; copies run on the devices' current streams, ordered
    after the work that produced the parts."""
    assert len(parts) == mesh.size
    _count("all_reduce_sum", parts[0])
    root = mesh.devices[0]
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(root)
    on_card = {card: total.to(card) for card in mesh.cards}
    return [on_card[d] for d in mesh.devices]


def replicate(mesh: DeviceMesh, x: torch.Tensor) -> List[torch.Tensor]:
    """x on every shard's device (one copy per card)."""
    _count("replicate", x)
    on_card = {card: x.to(card) for card in mesh.cards}
    return [on_card[d] for d in mesh.devices]


def neighbor_exchange(mesh: DeviceMesh, parts: Sequence[torch.Tensor],
                      step: int) -> List[Optional[torch.Tensor]]:
    """fem_tpu's `ppermute` along the mesh axis, without the wrap-around:
    shard i's tensor goes to shard i + step (step +1 or -1). Returns what
    each shard received, on its device; the end shard that has no sender
    receives None. Counted once, with one shard's operand."""
    assert len(parts) == mesh.size and step in (1, -1)
    _count("neighbor_exchange", parts[0])
    got: List[Optional[torch.Tensor]] = [None] * mesh.size
    for i, p in enumerate(parts):
        if 0 <= i + step < mesh.size:
            got[i + step] = p.to(mesh.devices[i + step])
    return got


def scatter(mesh: DeviceMesh, parts: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    """Deal the parts of a vector out from where they are (shard 0's device):
    part i onto shard i's device."""
    assert len(parts) == mesh.size
    _count("scatter", *parts)
    return [p.to(d) for p, d in zip(parts, mesh.devices)]


def gather(mesh: DeviceMesh, parts: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    """Collect a sharded vector: every part on shard 0's device."""
    assert len(parts) == mesh.size
    _count("gather", *parts)
    return [p.to(mesh.devices[0]) for p in parts]


# ---------------------------------------------------------------------------
# DOF-sharded vectors
# ---------------------------------------------------------------------------


class ShardedVector:
    """A vector cut into one tensor per shard (disjoint parts, each on its
    shard's device). Arithmetic is elementwise and local to each shard; a
    0-dim tensor operand (the result of a dot product, which every shard
    holds after its all-reduce) is read on each shard's device. `dot` and
    `norm` are the only operations that cross shards: one scalar all-reduce
    each."""

    def __init__(self, mesh: DeviceMesh, parts: Sequence[torch.Tensor]):
        assert len(parts) == mesh.size
        self.mesh = mesh
        self.parts = list(parts)

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def shape(self) -> Tuple[int]:
        return (sum(p.numel() for p in self.parts),)

    def _each(self, fn: Callable, other=None) -> "ShardedVector":
        if isinstance(other, ShardedVector):
            out = [fn(p, q) for p, q in zip(self.parts, other.parts)]
        elif torch.is_tensor(other):
            out = [fn(p, other.to(p.device)) for p in self.parts]
        else:
            out = [fn(p, other) for p in self.parts]
        return ShardedVector(self.mesh, out)

    def __add__(self, other):
        return self._each(lambda p, q: p + q, other)

    def __sub__(self, other):
        return self._each(lambda p, q: p - q, other)

    def __rsub__(self, other):
        return self._each(lambda p, q: q - p, other)

    def __mul__(self, other):
        return self._each(lambda p, q: p * q, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._each(lambda p, q: p / q, other)

    def to(self, dtype: torch.dtype) -> "ShardedVector":
        return self._each(lambda p, _: p.to(dtype))

    def clone(self) -> "ShardedVector":
        return self._each(lambda p, _: p.clone())

    def zero_(self) -> "ShardedVector":
        for p in self.parts:
            p.zero_()
        return self

    def dot(self, other: "ShardedVector") -> torch.Tensor:
        return all_reduce_sum(self.mesh, [
            torch.dot(p.reshape(-1), q.reshape(-1))
            for p, q in zip(self.parts, other.parts)])[0]

    def norm(self) -> torch.Tensor:
        return torch.sqrt(self.dot(self))


@dataclasses.dataclass(frozen=True)
class SlabLayout:
    """How a flat vector on shard 0 becomes a ShardedVector and back: `split`
    cuts it into the per-shard parts (there, on shard 0's device) and `join`
    is its inverse; scatter and gather move the parts, counted."""

    mesh: DeviceMesh
    split: Callable[[torch.Tensor], List[torch.Tensor]]
    join: Callable[[List[torch.Tensor]], torch.Tensor]

    def scatter(self, v: torch.Tensor) -> ShardedVector:
        return ShardedVector(self.mesh, scatter(self.mesh, self.split(v)))

    def gather(self, v: ShardedVector) -> torch.Tensor:
        return self.join(gather(self.mesh, v.parts))
