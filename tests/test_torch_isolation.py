"""Import hygiene and device rules of the port.

* No module under ``pilosa_tpu_torch/`` imports ``jax``, ``pilosa_tpu``
  or ``google.protobuf`` (AST scan, and a fresh interpreter that imports
  every module and finds none of them in ``sys.modules``).
* Entry points default to CUDA and raise when it is absent — no silent
  CPU path.
* Every kernel wrapper raises, rather than computing, for a tensor on a
  device it cannot launch on.
"""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import pilosa_tpu_torch  # noqa: E402
from pilosa_tpu_torch import device as device_mod  # noqa: E402
from pilosa_tpu_torch.ops import bitplane as tbp  # noqa: E402
from pilosa_tpu_torch.ops import delta_scatter as ds  # noqa: E402
from pilosa_tpu_torch.ops import fused_popcount as fp  # noqa: E402
from pilosa_tpu_torch.ops import score_planes  # noqa: E402

PKG = os.path.dirname(pilosa_tpu_torch.__file__)
FORBIDDEN = ("jax", "jaxlib", "pilosa_tpu", "google.protobuf")


def _modules() -> list[str]:
    out = []
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                out.append(os.path.join(dirpath, name))
    return sorted(out)


def _forbidden(mod: str) -> bool:
    return any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _modules(), ids=lambda p: os.path.relpath(p, PKG))
def test_module_imports_nothing_forbidden(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
            if node.module == "google":
                bad += [f"google.{a.name}" for a in node.names if a.name == "protobuf"]
    assert not bad, f"{path} imports {bad}"


def test_fresh_interpreter_loads_no_forbidden_module():
    mods = [
        "pilosa_tpu_torch." + os.path.relpath(p, PKG)[:-3].replace(os.sep, ".")
        for p in _modules()
        if not p.endswith("__main__.py")
    ]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r})]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(PKG)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.net.server import Server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.DeviceUnavailableError):
        Server(str(tmp_path))
    with pytest.raises(device_mod.DeviceUnavailableError):
        Server(str(tmp_path), device="cuda")
    with pytest.raises(device_mod.DeviceUnavailableError):
        Holder(str(tmp_path))
    assert Server(str(tmp_path), device="cpu").device == torch.device("cpu")


def test_storage_constructors_default_to_cuda(monkeypatch, tmp_path):
    """Index, Frame, View, Fragment and RowBitmap resolve their device
    like the entry points: CUDA unless asked, never a silent CPU."""
    import numpy as np

    from pilosa_tpu_torch.core.bitmap import RowBitmap
    from pilosa_tpu_torch.core.fragment import Fragment
    from pilosa_tpu_torch.core.frame import Frame
    from pilosa_tpu_torch.core.index import Index
    from pilosa_tpu_torch.core.view import View
    from pilosa_tpu_torch.net import codec, wire

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = str(tmp_path / "x")
    for make in (
        lambda: Index(p, "i"),
        lambda: Frame(p, "i", "f"),
        lambda: View(p, "i", "f", "standard"),
        lambda: Fragment(p, "i", "f", "standard", 0),
        lambda: RowBitmap.from_bits([1, 2]),
        lambda: RowBitmap().set_segment(0, np.zeros(tbp.WORDS_PER_SLICE, np.uint32)),
        lambda: codec.bitmap_from_proto(wire.Bitmap(Bits=[3])),
    ):
        with pytest.raises(device_mod.DeviceUnavailableError):
            make()
    # Asked for the CPU, the owner's device reaches everything below it.
    cpu = torch.device("cpu")
    idx = Index(str(tmp_path / "i"), "i", device="cpu")
    idx.open()
    frag = idx.create_frame("f").create_view_if_not_exists("standard")
    frag = frag.create_fragment_if_not_exists(0)
    assert frag.device == cpu and frag.device_plane().device == cpu
    idx.close()
    bm = codec.bitmap_from_proto(wire.Bitmap(Bits=[3, 1 << 20]), device="cpu")
    assert {s.device for s in bm.segments.values()} == {cpu}


def test_cli_defaults_to_cuda():
    from pilosa_tpu_torch.cli.main import build_parser

    args = build_parser().parse_args(["server", "--data-dir", "d", "--bind", "h:1"])
    assert args.device == "cuda"


def test_kernel_wrappers_raise_off_the_cpu():
    """A tensor the kernel cannot launch on (here on the meta device)
    raises in every wrapper instead of being computed another way."""
    import numpy as np

    a = torch.empty(3, tbp.WORDS_PER_SLICE, dtype=torch.int32, device="meta")
    before, ds_before, sp_before = fp.launches, ds.launches, score_planes.launches
    for call in (
        lambda: fp.row_popcounts(a),
        lambda: fp.row_popcounts(a, a, "and"),
        lambda: fp.row_popcounts(a, a[:1], "xor"),
        lambda: fp.fused_count(a),
        lambda: tbp.count(a),
        lambda: tbp.count_and(a, a),
        lambda: tbp.row_counts(a),
        lambda: score_planes.score_planes([a], np.zeros((1, 1), np.int64), [a[0]]),
        lambda: ds.delta_scatter(
            a, *[np.zeros(1, t) for t in (np.int32, np.int32, np.uint32, np.uint32)]
        ),
    ):
        with pytest.raises(ValueError):
            call()
    assert fp.launches == before and ds.launches == ds_before
    assert score_planes.launches == sp_before


def test_kernel_build_refuses_without_nvcc(monkeypatch):
    from pilosa_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(_build.KernelBuildError):
        _build.nvcc_path()


def test_ripple_kernel_raises_without_its_library(monkeypatch):
    """Where the planes are on the card, a missing K8 library raises out
    of every wrapper: no path computes the plain version instead."""
    import numpy as np

    from pilosa_tpu_torch.ops import _build
    from pilosa_tpu_torch.ops import bsi_ripple as br

    mirror = torch.zeros(5, tbp.WORDS_PER_SLICE, dtype=torch.int32)
    fp_ = br.FieldPlanes([mirror], np.array([[0, 1, 2, 3]], dtype=np.int64), 8, "cpu")

    def no_library(name):
        raise _build.KernelBuildError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(br, "_fns", {})
    monkeypatch.setattr(br, "_on_cuda", lambda *a: True)  # as for planes on the card
    before = dict(br.launches)
    for call in (lambda: br.bsi_cmp(fp_, "gt", 1), lambda: br.bsi_cmp(fp_, "between", -1, 1, True),
                 lambda: br.bsi_sum(fp_), lambda: br.bsi_minmax(fp_, "min")):
        with pytest.raises(_build.KernelBuildError):
            call()
    assert br.launches == before


def test_ripple_wrappers_raise_off_the_cpu():
    import numpy as np

    from pilosa_tpu_torch.ops import bsi_ripple as br

    meta = torch.empty(4, tbp.WORDS_PER_SLICE, dtype=torch.int32, device="meta")
    fp_ = br.FieldPlanes([meta], np.array([[0, 1, 2, 3]], dtype=np.int64), 8, "meta")
    before = dict(br.launches)
    for call in (lambda: br.bsi_cmp(fp_, "lt", 0), lambda: br.bsi_sum(fp_),
                 lambda: br.bsi_minmax(fp_, "max")):
        with pytest.raises(ValueError):
            call()
    assert br.launches == before
