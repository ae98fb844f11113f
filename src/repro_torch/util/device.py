"""Device selection for the port's entry points.

Entry points default to the card.  Asking for ``cuda`` where no card is
present raises instead of quietly running on the CPU: the plain PyTorch
path is reached only by asking for the CPU explicitly.  The one
exception is ``launch.specs.FAKE_MODE``: under it every tensor is a fake
tensor (a shape and a dtype, no storage), nothing runs, and ``cuda`` is
accepted with no card present.

:func:`is_fake` is the test the kernels' wrappers make before they
launch (a fake tensor takes their shape-only route), and
:func:`host_float` reads a scalar to the host, NaN for a fake one.
"""
from __future__ import annotations

import math
from typing import Union

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensor

DeviceLike = Union[str, torch.device]


def is_fake(t: torch.Tensor) -> bool:
    """True for a fake tensor, which has a shape, a dtype and a device
    but no data."""
    return isinstance(t, FakeTensor)


def host_float(t: torch.Tensor) -> float:
    """``float(t)``, or NaN for a fake tensor (it holds no value)."""
    return math.nan if is_fake(t) else float(t)


def _under_specs_mode() -> bool:
    # imported here: launch.specs imports the models, which import this
    from repro_torch.launch.specs import FAKE_MODE
    return detect_fake_mode() is FAKE_MODE


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    if (dev.type == "cuda" and not torch.cuda.is_available()
            and not _under_specs_mode()):
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev
