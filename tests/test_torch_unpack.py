"""K7 (the tile unpacker): the port's plain version
(``repro_torch.packing.pack.unpack_reference``, what ``unpack_operand``
runs for a CPU payload) is bit-equal to the reference's Pallas unpack
kernels (``_unpack_kernel`` / ``_unpack_quant_kernel`` through
``_unpack_pallas``) in interpret mode.

Each package packs the same f32 weight (numpy seed) with the same blocks;
the payload bytes are equal (``test_torch_packing.py``), and so is every
output bit: a float payload is a cast, a codec payload ``decode · scale``
in f32 and one cast.  The reference's interpret packer may differ from its
plain packer by one f32 ulp in a scale (``ROADMAP.md`` queue C), so the
reference side unpacks the payload and scales that the port packed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.packing import pack as jpack  # noqa: E402
from repro.packing.layout import PackedLayout as JLayout  # noqa: E402
from repro.packing.layout import PackedOperand as JOperand  # noqa: E402
from repro_torch.packing import pack as tpack  # noqa: E402

PAYLOADS = ("float32", "bfloat16", "int8", "int4", "fp8e4m3")
# (source shape, blocks, trans_w): ragged k and n, an odd bk, a grouped
# stack, and the reference's one-tile clamp.
SHAPES = {
    "2d": ((100, 70), (32, 32), False),
    "2d_trans_w_odd_bk": ((48, 101), (17, 16), True),
    "grouped": ((3, 40, 24), (16, 8), False),
    "grouped_trans_w": ((2, 30, 52), (15, 16), True),
    "one_tile": ((20, 12), (64, 64), False),
}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    return t.numpy()


def _reference_operand(p):
    lay = p.layout
    layout = JLayout(k=lay.k, n=lay.n, bk=lay.bk, bn=lay.bn, dtype=lay.dtype,
                     orig_dtype=lay.orig_dtype, trans_w=lay.trans_w, g=lay.g)
    return JOperand(jnp.asarray(_to_numpy(p.payload)),
                    None if p.scales is None else jnp.asarray(
                        p.scales.numpy()), layout)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_unpack_plain_is_bit_equal_to_reference_kernel(shape, payload, out):
    src, blocks, trans_w = SHAPES[shape]
    rng = np.random.default_rng(sorted(SHAPES).index(shape))
    w = (rng.standard_normal(src) * 0.3).astype(np.float32)
    p = tpack.pack_operand(torch.from_numpy(w), blocks, trans_w=trans_w,
                           dtype=payload)
    want = np.asarray(jpack._unpack_pallas(_reference_operand(p),
                                           jnp.dtype(out), interpret=True))
    before = tpack.unpack_operand.launches
    got = tpack.unpack_operand(p, dtype=out)
    assert tpack.unpack_operand.launches == before    # plain on the CPU
    assert got.dtype == getattr(torch, out)
    assert tuple(got.shape) == want.shape
    assert got.view(torch.uint8).numpy().tobytes() == \
        np.ascontiguousarray(want).view(np.uint8).tobytes()


@pytest.mark.parametrize("payload", PAYLOADS)
def test_unpack_default_dtype_round_trips(payload):
    """The default dtype is the payload's (the source's for a codec); a
    float payload of the source dtype round-trips exactly, and the result
    has the transpose resolved."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((24, 40)).astype(np.float32))
    p = tpack.pack_operand(w, (16, 16), trans_w=True, dtype=payload)
    got = tpack.unpack_operand(p)
    assert tuple(got.shape) == (40, 24)
    if payload == "float32":
        assert torch.equal(got, w.t())
    else:
        assert got.dtype == (torch.bfloat16 if payload == "bfloat16"
                             else torch.float32)
        torch.testing.assert_close(got.float(), w.t(), atol=0.6, rtol=0.3)
