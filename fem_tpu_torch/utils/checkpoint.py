"""Checkpoint / resume for the incremental stepper.

Port of `fem_tpu/utils/checkpoint.py:1-72`. The reference has no
checkpointing (SURVEY.md §5); its restartable state is exactly
(aggregate_u, aggregate_stress, Vec_U/du, dtNo) (main.F90:129-132, 216),
plus, for viscoelastic runs, the per-ip creep stress state. Each is a flat
npz written atomically per step, with fem_tpu's keys (`step`,
`aggregate_u`, `aggregate_stress`, `du`, `creep__<block>`), so a checkpoint
written by either package resumes in the other. `latest` finds the newest
step in a directory.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fem_tpu_torch.utils import timing

_CREEP_PREFIX = "creep__"


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save(path_dir: str, step: int, aggregate_u, aggregate_stress, du,
         creep_state: Optional[Dict] = None) -> str:
    """Write state_<step>.npz into path_dir through a temporary file and
    os.replace (no torn checkpoint on interruption); tensors go through the
    host. Returns the path."""
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, f"state_{step:06d}.npz")
    fd, tmp = tempfile.mkstemp(dir=path_dir, suffix=".tmp")
    extra = {_CREEP_PREFIX + name: _host(sigma)
             for name, sigma in (creep_state or {}).items()}
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, step=np.asarray(step), aggregate_u=_host(aggregate_u),
                     aggregate_stress=_host(aggregate_stress), du=_host(du),
                     **extra)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load(path: str, device=None, dtype=None) -> Tuple[int, object, object,
                                                       object, Dict]:
    """(step, aggregate_u, aggregate_stress, du, {block: creep state}):
    numpy arrays, or tensors on `device` in `dtype` when a device is
    given."""
    with np.load(path) as z:
        out = (z["aggregate_u"], z["aggregate_stress"], z["du"],
               {k[len(_CREEP_PREFIX):]: z[k] for k in z.files
                if k.startswith(_CREEP_PREFIX)})
        step = int(z["step"])
    if device is not None:
        def dev(a):
            return timing.upload(a, dtype=dtype, device=device)

        out = (dev(out[0]), dev(out[1]), dev(out[2]),
               {k: dev(v) for k, v in out[3].items()})
    return (step,) + out


def latest(path_dir: str) -> Optional[str]:
    """The newest state_*.npz in path_dir, or None."""
    if not os.path.isdir(path_dir):
        return None
    names = sorted(n for n in os.listdir(path_dir)
                   if n.startswith("state_") and n.endswith(".npz"))
    return os.path.join(path_dir, names[-1]) if names else None
