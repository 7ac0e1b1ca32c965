"""The device mesh and its collectives.

Port of `fem_tpu/parallel/mesh.py`. The reference's parallelism is one-axis
domain decomposition over mesh elements via METIS + MPI (SURVEY.md §2c);
fem_tpu's is one logical mesh axis under `shard_map`. The port is
single-controller, as `shard_map` is: one process holds a list of per-shard
tensors, each on its shard's device, and the collectives fem_tpu takes from
`jax.lax` (`psum`, a replicated operand) are the two functions below, over
such lists. They are the only places where data crosses shards, and
parallel/commcount.py records every call made while it listens.

`FEM_TPU_TORCH_VIRTUAL_DEVICES=N` in the environment is the counterpart of
XLA's `--xla_force_host_platform_device_count`: with it, up to N shards are
laid round-robin over the CUDA cards that exist, so that the sharded code
paths run on a machine with fewer cards than shards. Without it a mesh never
has more shards than cards. On the CPU every shard lies on the one CPU device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

# the lists that commcount.collectives is recording into
recorders: List[list] = []


def _count(name: str, x: torch.Tensor) -> None:
    for rec in recorders:
        rec.append((name, tuple(x.shape), x.numel() * x.element_size()))


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
