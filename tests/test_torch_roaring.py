"""The port's roaring codec (the pure-numpy path of the JAX package's):
the golden fixtures decode to expected.json, and encoding is byte-equal
with ``pilosa_tpu.ops.roaring``."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu.ops import roaring as jroaring  # noqa: E402
from pilosa_tpu_torch.ops import roaring as troaring  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

with open(os.path.join(GOLDEN, "expected.json")) as fh:
    EXPECTED = json.load(fh)


def load(name: str) -> bytes:
    with open(os.path.join(GOLDEN, name + ".roaring"), "rb") as fh:
        return fh.read()


def containers_to_bits(containers) -> list[int]:
    vals = []
    for key, words in containers.items():
        bits = np.unpackbits(words.view(np.uint8), bitorder="little")
        vals.extend(int(key) * troaring.CONTAINER_BITS + int(p) for p in np.nonzero(bits)[0])
    return sorted(vals)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_golden_decodes_to_expected(name):
    containers, op_n = troaring.decode_with_ops(load(name))
    assert containers_to_bits(containers) == EXPECTED[name]["bits"]
    assert op_n == EXPECTED[name]["ops"]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_golden_reencode_byte_equal_with_jax(name):
    containers = troaring.decode(load(name))
    assert troaring.encode(containers) == jroaring.encode(jroaring.decode(load(name)))


def _random_containers(seed: int) -> dict[int, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(rng.choice(200, size=12, replace=False)):
        w = np.zeros(1024, np.uint64)
        n = int(rng.choice([1, 100, 4096, 4097, 30000]))
        pos = rng.choice(1 << 16, size=min(n, 1 << 16), replace=False)
        np.bitwise_or.at(w, pos // 64, np.uint64(1) << (pos % 64).astype(np.uint64))
        out[int(key)] = w
    out[999] = np.zeros(1024, np.uint64)  # empty: dropped by both
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_byte_equal_with_jax(seed):
    containers = _random_containers(seed)
    data = troaring.encode(containers)
    assert data == jroaring.encode(containers)
    ops = troaring.encode_op(troaring.OP_ADD, 5) + troaring.encode_op(troaring.OP_REMOVE, 64 * 3)
    assert ops == jroaring.encode_op(jroaring.OP_ADD, 5) + jroaring.encode_op(
        jroaring.OP_REMOVE, 64 * 3
    )
    t_dec, t_ops = troaring.decode_with_ops(data + ops)
    j_dec, j_ops = jroaring.decode_with_ops(data + ops)
    assert t_ops == j_ops == 2
    assert containers_to_bits(t_dec) == containers_to_bits(j_dec)


def test_check_agrees_with_jax_on_corruption():
    data = bytearray(troaring.encode(_random_containers(3)))
    assert troaring.check(bytes(data)) == jroaring.check(bytes(data)) == []
    data[12] ^= 0xFF  # corrupt the first container's n
    assert bool(troaring.check(bytes(data))) == bool(jroaring.check(bytes(data)))
