"""Device resolution and device-memory residency for the port.

``resolve`` picks the torch device an entry point runs on: the CUDA
card by default.  A caller that wants the CPU asks for it
(``device="cpu"``, as the tests do); asking for CUDA on a machine
without it raises instead of silently running on the CPU.

The process has ONE set of devices, so it gets ONE residency manager,
as in the JAX package (``pilosa_tpu/device/__init__.py``): ``pool()``
returns the process-global :class:`PlanePool` that every long-lived
device tensor registers with (fragment mirrors and paged sparse rows),
and ``prefetcher()`` the shared :class:`Prefetcher` that uploads cold
mirrors in the background.  A ``Server`` configures the pool at open;
bare library use (tests) gets an unconfigured pool, whose budget comes
from ``PILOSA_DEVICE_HBM_BUDGET_BYTES`` or from the card's memory, and
is unbounded on the CPU — nothing evicts there unless a budget is set.
"""

from __future__ import annotations

import threading

import torch

from pilosa_tpu_torch.device.pool import PlanePool  # noqa: F401 — re-export
from pilosa_tpu_torch.device.prefetch import Prefetcher  # noqa: F401 — re-export

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


_mu = threading.Lock()
_pool: PlanePool | None = None
_prefetcher: Prefetcher | None = None


def pool() -> PlanePool:
    """The process-global residency manager."""
    global _pool
    if _pool is None:
        with _mu:
            if _pool is None:
                _pool = PlanePool()
    return _pool


def prefetcher() -> Prefetcher:
    """The shared prefetcher, bound to the global pool."""
    global _prefetcher
    if _prefetcher is None:
        with _mu:
            if _prefetcher is None:
                _prefetcher = Prefetcher()
    return _prefetcher


def _set_pool(p: PlanePool | None) -> PlanePool | None:
    """Swap the global pool (tests only); returns the previous one."""
    global _pool
    with _mu:
        prev = _pool
        _pool = p
        return prev


def bytes_by_device(t) -> dict:
    """``{device: bytes}`` of a tensor: a torch tensor lives whole on its
    one device (the JAX package splits a sharded array by shard; the
    port shards nothing)."""
    if t is None:
        return {}
    nbytes = int(t.numel() * t.element_size())
    return {t.device: nbytes} if nbytes else {}
