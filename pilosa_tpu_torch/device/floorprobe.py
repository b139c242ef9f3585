"""One-shot stream-floor probe.

Measures, per device, the memory-stream bandwidth of the access pattern
the bitmap kernels have — a read-everything reduction over a contiguous
uint32 buffer, the stream-sum kernel K11 (``ops/stream_sum.py``).  The
mean across devices becomes the roofline denominator
(``device.streamFloorGbps``): ``exec.launch.floorPct[site:*]`` on
``/debug/perf`` is a launch site's achieved GB/s over THIS number.

The port's counterpart of ``pilosa_tpu/device/floorprobe.py``, with its
contract: per-device GB/s and their mean, an in-process cache per key, a
``floorprobe.json`` cache under the data dir (restarts skip the
measurement), the ``device.streamFloorGbps`` gauges (aggregate and
``device:<i>``), ``PILOSA_FLOORPROBE_BYTES`` and :func:`reset_cache`.
Three things differ:

* the key is ``cuda:<device name>:<device count>``, or ``cpu:cpu:1``;
* on CUDA the buffer is at least 8x the card's L2 (rounded up to a power
  of two: 512 MiB on an H100, whose L2 holds 50 MiB), so the timed
  passes read device memory, not the L2 the warm-up filled; the JAX
  package's 32 MiB would fit in that L2.  The CPU keeps 4 MiB;
* the timed passes run between two CUDA events, with no synchronize
  inside the loop, and a failure to build or launch K11, or a wrong sum,
  RAISES: a floor of 0 would leave every ``floorPct`` unset.  Only the
  cache file's own errors are tolerated (a miss next boot);
* the result, and so the cache file, also holds ``launches``: the K11
  launches the measurement made (``stream_sum.launches`` read around it;
  0 on the CPU, whose plain version launches nothing), which is how a
  node's process shows another process what its open launched.
"""

from __future__ import annotations

import json
import os
import threading
import time

import torch

ENV_BYTES = "PILOSA_FLOORPROBE_BYTES"

DEFAULT_PROBE_BYTES = 32 << 20  # the JAX package's accelerator size: a floor here
CPU_PROBE_BYTES = 4 << 20
L2_MULTIPLE = 8
WARMUP_ITERS = 1
TIMED_ITERS = 4

CACHE_FILE = "floorprobe.json"

_mu = threading.Lock()
_cache: dict[str, dict] = {}  # key -> probe result (per process)


def _devices(device: torch.device) -> list[torch.device]:
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def backend_key(device: torch.device) -> str:
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        return f"cuda:{name}:{torch.cuda.device_count()}"
    return "cpu:cpu:1"


def probe_bytes(device: torch.device) -> int:
    """The buffer size: ``PILOSA_FLOORPROBE_BYTES`` when set to a positive
    integer, else 4 MiB on the CPU and, on CUDA, the power of two at or
    above ``L2_MULTIPLE`` x the card's L2 (never under 32 MiB)."""
    env = os.environ.get(ENV_BYTES)
    if env:
        try:
            n = int(env)
            if n > 0:
                return n
        except ValueError:
            pass
    if device.type != "cuda":
        return CPU_PROBE_BYTES
    l2 = int(getattr(torch.cuda.get_device_properties(device), "L2_cache_size", 0) or 0)
    want = max(DEFAULT_PROBE_BYTES, L2_MULTIPLE * l2)
    return 1 << (want - 1).bit_length()


def _load_disk(artifact_dir: str | None, key: str) -> dict | None:
    if not artifact_dir:
        return None
    path = os.path.join(artifact_dir, CACHE_FILE)
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        ent = doc.get(key)
        if isinstance(ent, dict) and "mean_gbps" in ent:
            return ent
    except (OSError, ValueError):
        pass
    return None


def _store_disk(artifact_dir: str | None, key: str, result: dict) -> None:
    if not artifact_dir:
        return
    path = os.path.join(artifact_dir, CACHE_FILE)
    try:
        os.makedirs(artifact_dir, exist_ok=True)
        doc: dict = {}
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                doc = {}
        except (OSError, ValueError):
            pass
        doc[key] = result
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # a cache miss next boot, not an error


def _expected(words: int) -> int:
    """The int32 sum of ``words`` ones, wrapped."""
    low = words & 0xFFFFFFFF
    return low - (1 << 32) if low >= 1 << 31 else low


def measure_device(dev: torch.device, n_bytes: int) -> float:
    """GB/s of ``TIMED_ITERS`` K11 passes over ``n_bytes`` of ones on
    ``dev``.  Raises when the kernel does not build, does not launch, or
    sums wrong."""
    from pilosa_tpu_torch.ops import stream_sum as ss

    words = max(1, n_bytes // 4)
    x = torch.ones(words, dtype=torch.int32, device=dev)
    try:
        for _ in range(WARMUP_ITERS):
            got = int(ss.stream_sum(x))  # build + warm; the host read waits
        if got != _expected(words):
            raise RuntimeError(
                f"stream floor probe: K11 summed {words} ones to {got} on {dev}"
            )
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(TIMED_ITERS):
                    ss.stream_sum(x)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(TIMED_ITERS):
                ss.stream_sum(x)
            dt = time.perf_counter() - t0
    finally:
        del x
    return (words * 4 * TIMED_ITERS / dt / 1e9) if dt > 0 else 0.0


def _measure(device: torch.device, key: str) -> dict:
    from pilosa_tpu_torch.ops import stream_sum as ss

    n_bytes = probe_bytes(device)
    words = max(1, n_bytes // 4)
    gbps: dict[str, float] = {}
    launches0 = ss.launches
    for dev in _devices(device):
        g = measure_device(dev, words * 4)
        gbps[str(dev.index if dev.index is not None else len(gbps))] = round(g, 3)
    vals = list(gbps.values())
    mean = sum(vals) / len(vals) if vals else 0.0
    return {
        "key": key,
        "probe_bytes": words * 4,
        "iters": TIMED_ITERS,
        "gbps": gbps,
        "mean_gbps": round(mean, 3),
        "launches": ss.launches - launches0,
    }


def probe(
    artifact_dir: str | None = None,
    stats=None,
    logger=None,
    force: bool = False,
    device: torch.device | str | None = None,
) -> dict:
    """Measure (or load cached) per-device stream GB/s for the devices of
    ``device``'s type (CUDA unless ``device`` is the CPU).

    Returns ``{"key", "probe_bytes", "iters", "gbps": {dev_id: g},
    "mean_gbps", "launches"}``.  Emits the ``device.streamFloorGbps`` gauge
    (aggregate + per-device) when a stats client is passed."""
    dev = torch.device("cuda" if device is None else device)
    key = backend_key(dev)
    with _mu:
        cached = None if force else _cache.get(key)
    result = cached
    source = "memory"
    if result is None and not force:
        result = _load_disk(artifact_dir, key)
        source = "disk"
    if result is None:
        result = _measure(dev, key)
        source = "probe"
        _store_disk(artifact_dir, key, result)
    with _mu:
        _cache[key] = result
    if stats is not None:
        stats.gauge("device.streamFloorGbps", result["mean_gbps"])
        for dev_id, g in result["gbps"].items():
            stats.with_tags(f"device:{dev_id}").gauge("device.streamFloorGbps", g)
    if logger is not None and source == "probe":
        logger(
            f"stream floor probe: {key} -> {result['mean_gbps']:.1f} GB/s "
            f"mean over {len(result['gbps'])} device(s), "
            f"{result['probe_bytes']} bytes"
        )
    return result


def reset_cache() -> None:
    """Tests only: forget in-process probe results."""
    with _mu:
        _cache.clear()
