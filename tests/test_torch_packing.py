"""The port's tile packing (``repro_torch.packing``) against the JAX
package's, on the CPU.

The port's ``pack_operand`` on a CPU tensor runs K6's plain version; the
reference runs ``pack_reference`` (``backend="xla"``) and its Pallas K6 body
in interpret mode.  Inputs are f32 (or bf16 through ``ml_dtypes``) arrays
drawn with numpy from a seed, so both packages see the same bits.

Tolerance: none against ``pack_reference``.  Payload and scales must be
byte-identical: the payload bytes are what the packed GEMM reads, and the
card's K6 is held to the same plain version byte for byte.  Unpacking is
compared bit for bit too (decode, one f32 product per element, one cast).

Against the interpret kernel the payload is byte-identical as well, but its
scales may differ by one f32 ulp: XLA compiles the kernel body's
``max(amax, 1e-8) / qmax`` as a product with the reciprocal of the
constant ``qmax``, while ``pack_reference`` (and the port, on both devices)
divides.  That is a disagreement inside the reference, recorded in ROADMAP
section C; the test asserts the one-ulp bound and that the port's scales
are the division's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.packing import pack as jpack  # noqa: E402
from repro_torch.packing import pack as tpack  # noqa: E402
from repro_torch.packing.layout import PackedOperand  # noqa: E402

DTYPES = ["bfloat16", "float32", "int8", "int4", "fp8e4m3"]

# (source shape, blocks, trans_w): ragged k and n, blocks larger than the
# extent (clamped), an odd bk (int4's dangling high nibble), and a source
# stored (n, k).
SHAPES = {
    "ragged_n": ((96, 136), (32, 64), False),
    "ragged_kn": ((100, 70), (32, 32), False),
    "odd_bk": ((100, 48), (33, 16), False),
    "clamped": ((40, 24), (256, 256), False),
    "trans_w": ((70, 100), (32, 32), True),
    "trans_w_odd_bk": ((48, 101), (17, 16), True),
}


def _source(name, src_dtype="float32"):
    shape = SHAPES[name][0]
    rng = np.random.default_rng(sorted(SHAPES).index(name))
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[0, 0] = 0.0
    w[-1, -1] = 0.37                      # a tile-dominant outlier
    if src_dtype == "bfloat16":
        return w.astype(ml_dtypes.bfloat16)
    return w


def _bytes_np(a):
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _bytes_t(t):
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def _torch_src(w):
    if w.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(w.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(w.copy())


def _assert_same(got: PackedOperand, want):
    assert got.layout.payload_shape == want.layout.payload_shape
    assert tuple(got.payload.shape) == tuple(want.payload.shape)
    assert got.payload.element_size() == np.asarray(want.payload).itemsize
    assert _bytes_t(got.payload) == _bytes_np(want.payload)
    if want.scales is None:
        assert got.scales is None
    else:
        assert got.scales.dtype == torch.float32
        assert tuple(got.scales.shape) == tuple(want.scales.shape)
        assert _bytes_t(got.scales) == _bytes_np(want.scales)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_pack_matches_reference_bytes(shape, dtype):
    _, blocks, trans_w = SHAPES[shape]
    w = _source(shape)
    want = jpack.pack_operand(jnp.asarray(w), blocks, trans_w=trans_w,
                              dtype=dtype, backend="xla")
    got = tpack.pack_operand(_torch_src(w), blocks, trans_w=trans_w,
                             dtype=dtype)
    _assert_same(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_matches_interpret_kernel_bytes(dtype):
    """The reference's Pallas K6 body, run in interpret mode: the same
    payload bytes; scales within one ulp (see the module docstring)."""
    _, blocks, trans_w = SHAPES["trans_w_odd_bk"]
    w = _source("trans_w_odd_bk")
    want = jpack.pack_operand(jnp.asarray(w), blocks, trans_w=trans_w,
                              dtype=dtype, backend="interpret")
    got = tpack.pack_operand(_torch_src(w), blocks, trans_w=trans_w,
                             dtype=dtype)
    assert tuple(got.payload.shape) == tuple(want.payload.shape)
    assert _bytes_t(got.payload) == _bytes_np(want.payload)
    if want.scales is None:
        assert got.scales is None
        return
    np.testing.assert_array_max_ulp(got.scales.numpy(),
                                    np.asarray(want.scales), maxulp=1)
    amax = np.abs(np.asarray(jpack._pack_dense_ref(
        jnp.asarray(w), want.layout))).max(axis=(-2, -1))
    division = (np.maximum(amax, np.float32(1e-8))
                / np.float32(want.layout.codec.qmax))
    assert _bytes_t(got.scales) == _bytes_np(division.astype(np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "int4", "fp8e4m3"])
def test_pack_of_a_bf16_source_matches_reference(dtype):
    _, blocks, trans_w = SHAPES["ragged_kn"]
    w = _source("ragged_kn", "bfloat16")
    want = jpack.pack_operand(jnp.asarray(w), blocks, trans_w=trans_w,
                              dtype=dtype, backend="xla")
    got = tpack.pack_operand(_torch_src(w), blocks, trans_w=trans_w,
                             dtype=dtype)
    assert got.layout.orig_dtype == want.layout.orig_dtype == "bfloat16"
    _assert_same(got, want)


@pytest.mark.parametrize("dtype", DTYPES + ["fp8", "e4m3"])
@pytest.mark.parametrize("shape", ["ragged_kn", "odd_bk", "trans_w"])
def test_layout_matches_reference(shape, dtype):
    src_shape, blocks, trans_w = SHAPES[shape]
    w = np.zeros(src_shape, np.float32)
    want = jpack.pack_operand(jnp.asarray(w), blocks, trans_w=trans_w,
                              dtype=dtype, backend="xla").layout
    got = tpack.pack_operand(torch.from_numpy(w), blocks, trans_w=trans_w,
                             dtype=dtype).layout
    for field in ("k", "n", "bk", "bn", "dtype", "orig_dtype", "trans_w",
                  "g", "bits_per_element", "nkb", "nnb", "payload_tile",
                  "payload_shape", "scales_shape", "per_tile_scales", "tag"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.describe() == want.describe()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ["odd_bk", "trans_w_odd_bk"])
def test_unpack_matches_reference(shape, dtype):
    _, blocks, trans_w = SHAPES[shape]
    w = _source(shape)
    jp = jpack.pack_operand(jnp.asarray(w), blocks, trans_w=trans_w,
                            dtype=dtype, backend="xla")
    want = np.asarray(jpack.unpack_operand(jp, dtype=jnp.float32,
                                           backend="xla"))
    tp = tpack.pack_operand(_torch_src(w), blocks, trans_w=trans_w,
                            dtype=dtype)
    got = tpack.unpack_operand(tp, dtype="float32")
    assert tuple(got.shape) == want.shape == (tp.layout.k, tp.layout.n)
    assert _bytes_t(got) == _bytes_np(want)
    if dtype in ("bfloat16", "float32"):      # float payloads round-trip
        dense = w.T if trans_w else w
        src = dense.astype(ml_dtypes.bfloat16).astype(np.float32) \
            if dtype == "bfloat16" else dense
        np.testing.assert_array_equal(got.numpy(), src)


def test_nibbles_round_trip_and_match_reference():
    rng = np.random.default_rng(5)
    for rows in (1, 6, 7):
        q = rng.integers(-7, 8, (2, rows, 9)).astype(np.int8)
        packed = tpack.pack_nibbles(torch.from_numpy(q))
        assert packed.dtype == torch.int8
        assert tuple(packed.shape) == (2, (rows + 1) // 2, 9)
        assert _bytes_t(packed) == _bytes_np(jpack.pack_nibbles(
            jnp.asarray(q)))
        back = tpack.unpack_nibbles(packed, rows)
        np.testing.assert_array_equal(back.numpy(), q)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jpack.unpack_nibbles(
                jnp.asarray(packed.numpy()), rows)))
    # Low nibble = even k, high nibble = odd k; odd rows pad with zero.
    q = torch.tensor([[-7], [3], [5]], dtype=torch.int8)
    assert tpack.pack_nibbles(q).flatten().tolist() == [0x39, 0x05]


def test_unpack_refuses_a_payload_off_the_cpu():
    """A payload off the CPU runs K7 on the card and raises on any other
    device: it never falls back to the plain version."""
    p = tpack.pack_operand(torch.ones(8, 4), (4, 4), dtype="int8")
    with pytest.raises(ValueError, match="device"):
        tpack.unpack_operand(p.to("meta"))
    assert tpack.unpack_operand.launches == 0
    with pytest.raises(ValueError, match="device"):
        tpack.pack_operand(torch.ones(8, 4, device="meta"), (4, 4))
    assert tpack.pack_operand.launches == 0


# Grouped (MoE expert) stacks: (G, k, n), or (G, n, k) under trans_w, with
# ragged k and n and an odd bk.
GROUPED = {
    "stack": ((3, 100, 70), (32, 32), False),
    "stack_trans_w_odd_bk": ((4, 48, 101), (17, 16), True),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", sorted(GROUPED))
def test_grouped_pack_matches_reference_bytes(shape, dtype):
    """One grouped pack of the whole stack: the reference's payload
    (g, nkb, nnb, tk, bn) and scales (g, nkb, nnb), byte for byte, and the
    reference's layout."""
    src_shape, blocks, trans_w = GROUPED[shape]
    rng = np.random.default_rng(21 + sorted(GROUPED).index(shape))
    w = (rng.standard_normal(src_shape) * 0.05).astype(np.float32)
    w[1, -1, -1] = 0.37
    want = jpack.pack_operand(jnp.asarray(w), blocks, trans_w=trans_w,
                              dtype=dtype, backend="xla")
    got = tpack.pack_operand(torch.from_numpy(w), blocks, trans_w=trans_w,
                             dtype=dtype)
    for field in ("k", "n", "bk", "bn", "g", "payload_shape",
                  "scales_shape", "tag"):
        assert getattr(got.layout, field) == getattr(want.layout, field)
    assert got.layout.describe() == want.layout.describe()
    assert got.shape == tuple(want.shape)
    _assert_same(got, want)
    # Each group is the 2-D pack of its own slice.
    for i in range(src_shape[0]):
        one = tpack.pack_operand(torch.from_numpy(w[i]), blocks,
                                 trans_w=trans_w, dtype=dtype)
        assert _bytes_t(one.payload) == _bytes_t(got.payload[i])
    # And unpacks back to the reference's dense stack.
    back = tpack.unpack_operand(got, dtype="float32")
    ref = np.asarray(jpack.unpack_operand(want, dtype=jnp.float32,
                                          backend="xla"))
    assert _bytes_t(back) == _bytes_np(ref)


def test_one_group_stack_packs_as_its_slice():
    """A (1, k, n) stack has the layout of its (k, n) slice (``g`` = 1, no
    group axis, as the reference's layout has) and the same bytes; the
    grouped GEMM takes it.  The reference's ``pack_reference`` refuses such
    a stack (ROADMAP C), so the slice is the yardstick."""
    from repro_torch.core.gemm import mp_dot, mp_dot_grouped

    rng = np.random.default_rng(31)
    w = (rng.standard_normal((1, 40, 24)) * 0.05).astype(np.float32)
    for dtype in DTYPES:
        got = tpack.pack_operand(torch.from_numpy(w), (16, 8), dtype=dtype)
        want = tpack.pack_operand(torch.from_numpy(w[0]), (16, 8),
                                  dtype=dtype)
        assert got.layout == want.layout and got.layout.g == 1
        assert _bytes_t(got.payload) == _bytes_t(want.payload)
    x = torch.from_numpy(rng.standard_normal((1, 3, 40)).astype(np.float32))
    torch.testing.assert_close(mp_dot_grouped(x, got, policy="fp32")[0],
                               mp_dot(x[0], want, policy="fp32"),
                               atol=0, rtol=0)
