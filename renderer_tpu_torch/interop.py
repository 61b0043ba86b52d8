"""Host arrays → the port's tensors, with the same keys and dtypes.

Used to feed the JAX package and the port identical inputs: the `geom` and
`materials` dicts a Renderer uploads, a packed frame blob, binned buffers.
uint32 arrays (the packed RGBA8 atlas) keep their bits as int32, the dtype
the port stores them in. `resolve_device` is the one check of the device
every entry point runs on.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. Asking for CUDA where there
    is none raises: nothing moves the work to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def from_numpy_arrays(d, device="cuda"):
    """Convert a numpy array, or a dict / list / tuple nesting them, to
    torch tensors on `device` (the card unless the caller asks for the
    CPU). Anything else (None, Python scalars) passes
    through unchanged."""
    if isinstance(d, dict):
        return {k: from_numpy_arrays(v, device) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return type(d)(from_numpy_arrays(v, device) for v in d)
    if isinstance(d, np.ndarray):
        a = np.ascontiguousarray(d)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.copy()).to(device)
    return d
