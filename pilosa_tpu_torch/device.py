"""Device resolution for the port's entry points.

The default is the CUDA card.  A caller that wants the CPU asks for it
(``device="cpu"``, as the tests do); asking for CUDA on a machine
without it raises instead of silently running on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


class DeviceUnavailableError(RuntimeError):
    pass


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The torch device an entry point runs on: ``device`` or the CUDA
    default.  Raises :class:`DeviceUnavailableError` for a CUDA device
    when ``torch.cuda.is_available()`` is false, and ``ValueError`` for
    a device type the port does not run on."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "CUDA device requested but torch.cuda.is_available() is "
                "false; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device type: {dev.type!r}")
