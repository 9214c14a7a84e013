"""K6's and K7's designs and the rules that pick them, on the CPU.

* :func:`k6_design` sends a pack to the stream kernel
  (``csrc/pack.cu::pack_stream_kernel``) or to the scalar one
  (``pack_kernel``) from what the operands are: the source dtype, a
  contiguous 16-byte-aligned source, its contiguous axis and the tile's
  span along it in multiples of 16 bytes, payload rows of a multiple of 16
  bytes, and a tile that fits the design's shared memory.
* :func:`k7_design` does the same for an unpack (``unpack_stream_kernel`` /
  ``unpack_kernel``): the output dtype, a contiguous 16-byte-aligned
  payload, tile rows and logical rows of a multiple of 8 columns.
* Every weight that ``pack_params`` and ``sparsify_params`` pack for
  phi3-mini and granite-moe -- the smoke configs packed here for real, the
  full-width ones expressed as layouts over meta tensors -- takes the
  stream design for its pack and for its unpack, edge tiles included.

The kernels themselves have no CPU mode: ``tests/test_torch_cuda.py``
holds both designs byte for byte against the plain versions on the card.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as cb  # noqa: E402
from repro_torch.kernels import counters  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.packing import params as pparams  # noqa: E402
from repro_torch.packing.layout import PackedOperand  # noqa: E402
from repro_torch.packing.pack import (  # noqa: E402
    K6_STREAM_MAX_FLOATS, _layout_for, k6_design, k7_design, pack_operand,
)
from repro_torch.sparse import sparsify  # noqa: E402

PAYLOADS = ("float32", "bfloat16", "int8", "int4", "fp8e4m3")
ARCHS = ("phi3-mini-3.8b", "granite-moe-1b-a400m")


def _design(w, blocks=(128, 128), trans_w=False, dtype="int8"):
    return k6_design(w, _layout_for(w, *blocks, trans_w=trans_w,
                                    dtype=dtype))


def _misaligned(shape, dtype, offset):
    """A contiguous view of ``shape`` that starts ``offset`` elements into
    its storage."""
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


def _packed(k, n, blocks, payload, g=1, offset=0):
    """A packed operand over an empty payload of the layout's shape (the
    rule reads dtypes, shapes and addresses, never values)."""
    w = torch.empty((g, k, n) if g > 1 else (k, n), device="meta")
    layout = _layout_for(w, *blocks, trans_w=False, dtype=payload)
    shape = layout.payload_shape
    if offset:
        buf = _misaligned(shape, layout.storage_dtype, offset)
    else:
        buf = torch.empty(shape, dtype=layout.storage_dtype, device="meta")
    return PackedOperand(buf, None, layout)


# --- K6's rule ---------------------------------------------------------------

@pytest.mark.parametrize("dtype,want", [
    (torch.float32, "stream"), (torch.bfloat16, "stream"),
    (torch.float16, "simt"), (torch.float64, "simt"),
])
@pytest.mark.parametrize("payload", PAYLOADS)
def test_k6_design_source_dtype(dtype, want, payload):
    w = torch.zeros(256, 384, dtype=dtype)
    assert _design(w, dtype=payload) == want


@pytest.mark.parametrize("dtype,offset,want", [
    (torch.float32, 0, "stream"), (torch.float32, 1, "simt"),
    (torch.float32, 2, "simt"), (torch.float32, 4, "stream"),
    (torch.bfloat16, 1, "simt"), (torch.bfloat16, 4, "simt"),
    (torch.bfloat16, 8, "stream"),
])
@pytest.mark.parametrize("trans_w", [False, True])
def test_k6_design_needs_a_16_byte_aligned_source(dtype, offset, want,
                                                  trans_w):
    w = _misaligned((128, 256), dtype, offset)
    assert w.is_contiguous()
    assert _design(w, trans_w=trans_w) == want


def test_k6_design_needs_a_contiguous_source():
    w = torch.zeros(256, 128)
    assert _design(w.t()) == "simt"
    assert _design(w.t().contiguous()) == "stream"
    stack = torch.zeros(256, 4, 128).permute(1, 0, 2)
    assert _design(stack) == "simt"
    assert _design(stack.contiguous()) == "stream"


@pytest.mark.parametrize("k,n,trans_w,dtype,want", [
    # The contiguous axis: n, or k under trans_w, in 16-byte multiples.
    (100, 260, False, torch.float32, "stream"),     # 1040 bytes
    (100, 258, False, torch.float32, "simt"),       # 1032
    (100, 264, False, torch.bfloat16, "stream"),    # 528
    (100, 260, False, torch.bfloat16, "simt"),      # 520
    (100, 1, False, torch.float32, "simt"),
    (260, 256, True, torch.float32, "stream"),
    (264, 256, True, torch.bfloat16, "stream"),
    (258, 256, True, torch.float32, "simt"),
    (260, 256, True, torch.bfloat16, "simt"),
])
def test_k6_design_pitch(k, n, trans_w, dtype, want):
    w = torch.zeros(*((n, k) if trans_w else (k, n)), dtype=dtype)
    assert _design(w, trans_w=trans_w) == want


@pytest.mark.parametrize("n,blocks,payload,want", [
    (768, (128, 128), "int8", "stream"),
    (768, (32, 32), "int8", "stream"),
    (96, (128, 24), "float32", "stream"),     # payload rows of 96 bytes
    (96, (128, 24), "bfloat16", "stream"),    # 48
    (96, (128, 24), "int8", "simt"),          # 24
    (768, (128, 40), "fp8e4m3", "simt"),
    (768, (64, 256), "int4", "stream"),       # 64 x 256 f32: 64 KiB
    (768, (128, 256), "int4", "simt"),        # 128 KiB of shared tile
    (768, (256, 128), "int8", "simt"),
    (200, (128, 100), "float32", "stream"),   # 128 x 128 once rounded to 32
    (768, (129, 112), "float32", "simt"),     # 129 x 128 once rounded
    (768, (128, 36), "float32", "stream"),    # a source span of 144 bytes
    (768, (128, 36), "bfloat16", "simt"),     # bf16 payload rows of 72
])
def test_k6_design_blocks(n, blocks, payload, want):
    w = torch.zeros(512, n)
    assert _design(w, blocks=blocks, dtype=payload) == want


def test_k6_design_bf16_source_span():
    w = torch.zeros(512, 768, dtype=torch.bfloat16)
    assert _design(w, blocks=(128, 36), dtype="float32") == "simt"   # 72 B
    assert _design(w, blocks=(128, 40), dtype="float32") == "stream"


def test_k6_design_max_tile():
    """bk x bn rounded up to 32 floats, at most 64 KiB of f32."""
    assert K6_STREAM_MAX_FLOATS == 128 * 128
    w = torch.zeros(1024, 512)
    assert _design(w, blocks=(512, 32)) == "stream"
    assert _design(w, blocks=(1024, 32)) == "simt"
    assert _design(w, blocks=(512, 48)) == "simt"
    assert _design(w, blocks=(256, 64)) == "stream"


@pytest.mark.parametrize("k,trans_w,want", [
    (97, False, "stream"),    # bk = 97: the last payload row's high
    (33, False, "stream"),    # nibbles are zero
    (97, True, "simt"),       # an odd k is an odd contiguous axis
    (96, True, "stream"),
])
def test_k6_design_odd_bk_int4(k, trans_w, want):
    w = torch.zeros(*((128, k) if trans_w else (k, 128)))
    layout = _layout_for(w, 128, 128, trans_w=trans_w, dtype="int4")
    assert layout.bk == k
    assert k6_design(w, layout) == want


@pytest.mark.parametrize("shape,blocks,trans_w,want", [
    ((32, 1024, 512), (128, 128), False, "stream"),
    ((32, 512, 1024), (128, 128), False, "stream"),
    ((3, 136, 264), (128, 128), False, "stream"),
    ((2, 264, 136), (128, 128), True, "stream"),
    ((4, 100, 70), (32, 32), False, "simt"),
    ((70000, 8, 16), (8, 16), False, "simt"),     # groups past the grid
])
def test_k6_design_grouped(shape, blocks, trans_w, want):
    w = torch.empty(shape, device="meta")
    assert _design(w, blocks=blocks, trans_w=trans_w) == want


def test_k6_design_tile_rows_past_the_grid():
    w = torch.empty(70000 * 4, 16, device="meta")
    assert _design(w, blocks=(4, 16)) == "simt"
    assert _design(w, blocks=(8, 16)) == "stream"


# --- K7's rule ---------------------------------------------------------------

@pytest.mark.parametrize("dtype,want", [
    (torch.float32, "stream"), (torch.bfloat16, "stream"),
    ("float32", "stream"), ("bfloat16", "stream"),
    (torch.float16, "simt"), (torch.int8, "simt"),
])
@pytest.mark.parametrize("payload", PAYLOADS)
def test_k7_design_output_dtype(dtype, want, payload):
    assert k7_design(_packed(256, 384, (128, 128), payload), dtype) == want


@pytest.mark.parametrize("k,n,blocks,want", [
    (3072, 8192, (128, 128), "stream"),
    (300, 264, (128, 128), "stream"),     # ragged on both axes
    (97, 160, (128, 128), "stream"),      # odd bk
    (40, 24, (16, 8), "stream"),
    (100, 70, (32, 32), "simt"),          # n % 8
    (100, 64, (32, 12), "simt"),          # bn % 8
    (101, 48, (17, 16), "stream"),
])
@pytest.mark.parametrize("payload", PAYLOADS)
def test_k7_design_rows(k, n, blocks, want, payload):
    assert k7_design(_packed(k, n, blocks, payload), torch.bfloat16) == want


@pytest.mark.parametrize("payload,offset,want", [
    ("int8", 8, "simt"), ("int8", 16, "stream"), ("int4", 4, "simt"),
    ("bfloat16", 4, "simt"), ("bfloat16", 8, "stream"),
    ("float32", 2, "simt"), ("float32", 4, "stream"),
])
def test_k7_design_needs_a_16_byte_aligned_payload(payload, offset, want):
    p = _packed(256, 256, (128, 128), payload, offset=offset)
    assert k7_design(p, torch.float32) == want


def test_k7_design_needs_a_contiguous_payload():
    p = _packed(256, 256, (128, 128), "int8")
    buf = torch.zeros(p.layout.payload_shape[::-1], dtype=torch.int8)
    assert k7_design(PackedOperand(buf.permute(3, 2, 1, 0), None, p.layout),
                     torch.bfloat16) == "simt"


@pytest.mark.parametrize("g,k,n,want", [
    (32, 1024, 512, "stream"), (32, 512, 1024, "stream"),
    (3, 136, 264, "stream"), (3, 136, 260, "simt"),
])
def test_k7_design_grouped(g, k, n, want):
    p = _packed(k, n, (128, 128), "int4", g=g)
    assert p.layout.g == g
    assert k7_design(p, torch.bfloat16) == want


# --- every weight the ported models pack takes the stream design ------------

def _record(monkeypatch, module):
    """Wrap ``module.pack_operand`` to note each call's K6 design and the
    K7 designs of the result (f32 and bf16 output) -> the notes."""
    seen = []

    def recorded(w, blocks, *, trans_w=False, dtype=None):
        layout = _layout_for(w, *blocks, trans_w=trans_w, dtype=dtype)
        if w.device.type == "meta":
            p = _packed(layout.k, layout.n, (layout.bk, layout.bn),
                        layout.dtype, g=layout.g)
        else:
            p = pack_operand(w, blocks, trans_w=trans_w, dtype=dtype)
        seen.append((tuple(w.shape), layout.describe(), k6_design(w, layout),
                     k7_design(p, torch.float32),
                     k7_design(p, torch.bfloat16)))
        return p

    monkeypatch.setattr(module, "pack_operand", recorded)
    return seen


def _all_stream(seen):
    assert seen
    off = [s for s in seen if s[2:] != ("stream",) * 3]
    assert not off, off


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_smoke_weight_packs_and_unpacks_on_the_stream_design(
        monkeypatch, arch, payload):
    """``LM.init(pack=True)`` on the CPU: every weight ``pack_params``
    packs, 2-D or an expert stack, with edge tiles where the width is not
    a multiple of 128 (phi3's d_ff 192)."""
    seen = _record(monkeypatch, pparams)
    model = T.build_model(cb.get(arch, smoke=True), device="cpu",
                          policy="int8" if payload == "int8" else
                          "fp32" if payload == "float32" else "bf16")
    fmt = payload if payload in ("int4", "fp8e4m3") else None
    model.init(torch.Generator().manual_seed(0), pack=True, pack_format=fmt)
    _all_stream(seen)
    if arch.startswith("granite"):
        assert any(len(s[0]) == 3 for s in seen)      # the expert stacks


@pytest.mark.parametrize("method,policy", [("magnitude", "bf16"),
                                           ("nm", "int8")])
@pytest.mark.parametrize("blocks", [None, (32, 32)])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_smoke_weight_sparsifies_on_the_stream_design(
        monkeypatch, arch, method, policy, blocks):
    """``LM.init(sparsity=0.5)`` on the CPU: every pack that
    ``sparsify.build_payload`` makes, at the default 128 x 128 blocks and
    at the CLI's 32 x 32."""
    seen = _record(monkeypatch, sparsify)
    model = T.build_model(cb.get(arch, smoke=True), device="cpu",
                          policy=policy)
    model.init(torch.Generator().manual_seed(0), sparsity=0.5,
               sparsity_method=method, sparsity_blocks=blocks)
    _all_stream(seen)


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_full_width_weight_takes_the_stream_design(monkeypatch, arch,
                                                        payload):
    """The full-width models' weights as layouts: every layer kind's f32
    draw and the untied head, on meta tensors, through ``pack_params`` at
    the default blocks (a sparse load packs the same sources at the same
    blocks: bf16 and int8 payloads)."""
    seen = _record(monkeypatch, pparams)
    cfg = cb.get(arch)
    model = T.build_model(cfg, device="meta")
    g = torch.Generator()
    for kind in dict.fromkeys(cfg.pattern):
        pparams.pack_params(T._INIT[kind](cfg, generator=g, device="meta"),
                            pack_format=payload if payload in (
                                "int8", "int4", "fp8e4m3") else None,
                            policy="fp32" if payload == "float32" else "bf16")
    if not cfg.tie_embeddings:
        pparams.pack_params(
            {"head": torch.empty(cfg.d_model, model.vocab_padded,
                                 device="meta")}, policy="bf16")
    _all_stream(seen)
    shapes = {s[0] for s in seen}
    if arch.startswith("phi3"):
        assert (3072, 8192) in shapes and (3072, 32128) in shapes
    else:
        assert (32, 1024, 512) in shapes and (1024, 512) in shapes


# --- the counters --------------------------------------------------------------

def test_stream_counters_are_registered():
    names = counters.launch_counts()
    assert "k6_stream" in names and "k7_stream" in names
    wrappers = counters.wrappers()
    assert wrappers["k6"].stream_launches == names["k6_stream"]
    assert wrappers["k7"].stream_launches == names["k7_stream"]


def test_stream_counters_reset_and_add(monkeypatch):
    before = counters.launch_counts()
    try:
        counters.reset_launch_counts()
        assert counters.launch_counts()["k6_stream"] == 0
        counters.add_launch_counts({"k6_stream": 2, "k7_stream": 3})
        now = counters.launch_counts()
        assert (now["k6_stream"], now["k7_stream"]) == (2, 3)
        assert counters.count_delta(now, dict(now, k6_stream=0)) == {
            "k6_stream": 2}
    finally:
        counters.reset_launch_counts()
        counters.add_launch_counts(before)


def test_cpu_packs_count_no_launch():
    before = counters.launch_counts()
    pack_operand(torch.zeros(256, 256), (128, 128), dtype="int8")
    assert counters.launch_counts() == before
