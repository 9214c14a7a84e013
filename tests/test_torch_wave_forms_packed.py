"""The cross and recurrent architectures packed (``--pack``), on the port's
wave path against the JAX package's, on the CPU, at their smoke sizes
(llama-3.2-vision-11b, rwkv6-1.6b, recurrentgemma-2b; the helpers and the
perturbed parameter tree are ``torch_wave_forms.py``'s).

The reference packs its tree (``repro.packing.pack_params``: every leaf of
``QUANT_LEAVES``, in the stacks of units of 5 and 3, recurrentgemma's
unstacked tail and the cross block's nested ``xattn`` and ``mlp``) and
``params_from_jax`` carries the payloads across byte for byte.  Every
payload: bf16 (the bf16 policy's own), int8, int4 and fp8 under bf16
(``PAYLOADS``), and int8 under the int8 policy.  The RG-LRU gates stay
on the fp32 policy against a packed weight: a bf16 payload is cast to
f32 at each call, a scaled one (int8, int4, fp8) is read against f32
activations -- K2's f32-A route, as in the reference; nothing is
unpacked.

The bf16 payloads and the int4 and fp8 ones are held against the
reference's default backend (XLA, which unpacks each payload and casts it
to the activations' dtype: the weights the kernel decodes); int8 payloads
against its ``interpret`` backend (its Pallas bodies), and under the int8
policy op by op (see ``torch_wave_forms.py``).

Tolerances: logits atol = rtol = 3e-2 (``TOL``, as
``test_torch_serve_packed.py``); decode steps against a longer prefill the
same.  Packed leaves are compared byte for byte.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_wave_forms as W  # noqa: E402

from repro.core import config as jcfg  # noqa: E402
from repro.core.gemm import mp_dot as jmp_dot  # noqa: E402
from repro.packing import pack_operand as jpack_operand  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.core import gemm as gemm_mod  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    _packed_from_jax, build_model as tbuild, params_from_jax,
)
from repro_torch.packing.layout import PackedOperand  # noqa: E402
from repro_torch.packing.params import (  # noqa: E402
    pack_params, packed_param_bytes,
)
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

# The payloads under bf16 by architecture: recurrentgemma every one (its
# gates read each on K2's f32-A route), the other two three each (int8
# under the int8 policy is llama-vision's, below).
PAYLOADS = [("llama-3.2-vision-11b", None), ("llama-3.2-vision-11b", "int4"),
            ("llama-3.2-vision-11b", "fp8"), ("rwkv6-1.6b", None),
            ("rwkv6-1.6b", "int8"), ("rwkv6-1.6b", "fp8"),
            ("recurrentgemma-2b", None), ("recurrentgemma-2b", "int8"),
            ("recurrentgemma-2b", "int4"), ("recurrentgemma-2b", "fp8")]


@pytest.mark.parametrize("arch,pack_format", PAYLOADS)
def test_packed_bf16_prefill_and_decode_match_reference(arch, pack_format):
    """Two 8-token rows, then two decode steps, each payload under the
    bf16 policy: logits against the reference's, and the last decode step
    against one longer prefill of the same tokens."""
    jm, jp, tm, tp, _ = W.pair(arch, "bf16", ("pack", pack_format))
    packed = W.operands(tp, PackedOperand)
    assert len(packed) == W.chip_smoke()._wave_weights(tm.cfg)
    assert {p.layout.dtype for p in packed} == {
        {None: "bfloat16", "fp8": "fp8e4m3"}.get(pack_format, pack_format)}
    backend = "interpret" if pack_format == "int8" else "xla"
    pairs, _, _, toks, img = W.run_both(jm, jp, tm, tp, backend=backend)
    W.assert_pairs_close(pairs)
    np.testing.assert_allclose(pairs[-1][0],
                               W.longer_prefill(tm, tp, toks, img),
                               **W.TOL)


def test_packed_int8_policy_matches_interpret_kernel():
    """llama-vision under the int8 policy, int8 payloads (the cross K/V
    over the image states through the packed kernel at prefill): logits
    and every cache tensor against the reference's interpret backend, op
    by op."""
    jm, jp, tm, tp, _ = W.pair("llama-3.2-vision-11b", "int8",
                               ("pack", None))
    assert {p.layout.dtype for p in W.operands(tp)} == {"int8"}
    pairs, tc, jc, _, _ = W.run_both(jm, jp, tm, tp, backend="interpret",
                                     eager=True)
    W.assert_pairs_close(pairs)
    for got, want, path in W.cache_leaves(tc, jc, tm.cfg):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **W.TOL, err_msg=str(path))


@pytest.mark.parametrize("policy,pack_format", [("bf16", "int4"),
                                                ("int8", None)])
@pytest.mark.parametrize("arch", W.ARCHS)
def test_own_pack_params_with_reference_blocks_is_byte_identical(
        arch, policy, pack_format):
    """The port packs the f32 tree itself: given the reference's blocks,
    it packs the reference's leaves on each kind, byte for byte."""
    _, _, tm, tp, tree = W.pair(arch, policy, ("pack", pack_format))
    dense = params_from_jax(tree, tm.cfg)
    blocks = {(p.layout.k, p.layout.n): (p.layout.bk, p.layout.bn)
              for p in W.operands(tp)}
    own = tm.load_params(pack_params(dense, policy=policy,
                                     pack_format=pack_format,
                                     blocks=lambda k, n: blocks[(k, n)]))
    mine, theirs = list(W.leaves(own)), list(W.leaves(tp))
    assert len(mine) == len(theirs)
    n_packed = 0
    for a, b in zip(mine, theirs):
        assert isinstance(a, PackedOperand) == isinstance(b, PackedOperand)
        if not isinstance(a, PackedOperand):
            assert a.dtype == b.dtype and torch.equal(a, b)
            continue
        n_packed += 1
        assert a.layout == b.layout
        assert torch.equal(a.payload.view(torch.uint8),
                           b.payload.view(torch.uint8))
        assert (a.scales is None) == (b.scales is None)
        if a.scales is not None:
            assert torch.equal(a.scales, b.scales)
    assert n_packed == W.chip_smoke()._wave_weights(tm.cfg)
    assert packed_param_bytes(own) == packed_param_bytes(tp)


@pytest.mark.parametrize("policy,pack_format", [("int8", None),
                                                ("bf16", None),
                                                ("bf16", "fp8")])
@pytest.mark.parametrize("arch", W.ARCHS)
def test_packed_launches_are_what_chip_smoke_counts(arch, policy,
                                                    pack_format, monkeypatch):
    """A prefill and a decode step of the packed smoke model (the port's
    own 128 x 128 blocks) number the wrapper calls
    ``chip_smoke._want_wave_launches`` asserts on the card, with no weight
    unpacked; the packed kernel takes every projection and the gates (f32
    A: a bf16 payload cast to f32, a scaled one as it is), K1 ``lora_a``,
    ``w_lora_a`` (under the policy) and the tied head."""
    tm = tbuild(tcb.get(arch, smoke=True), policy=policy, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0), pack=True,
                 pack_format=pack_format)
    calls = W.check_counts(monkeypatch, tm, tp, "k2")
    k1_a = torch.int8 if policy == "int8" else torch.bfloat16
    k2_a = torch.bfloat16 if pack_format == "fp8" else k1_a
    for c in calls:
        if c == "k4" or c.grouped:
            continue
        if c.kernel == "k1":
            assert c.a_dtype == k1_a and not c.f32_fma, c
        elif c.a_dtype == torch.float32:
            assert tm.cfg.name.startswith("recurrentgemma"), c
        else:
            assert c.a_dtype == k2_a, c


def test_float_payload_under_int8_unpacks_only_where_the_reference_does(
        monkeypatch):
    """The one place the packed path unpacks: a float payload under the
    int8 policy (its per-tensor weight quantization needs the dense
    weight), as the reference's ``core/gemm.py`` does; under the fp32
    policy (the RG-LRU gates) the same payload is cast to f32 and read
    packed.  Both against the reference's interpret backend."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((128, 128)) / 11.0).astype(np.float32)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    jp = jpack_operand(jnp.asarray(w), (128, 128), dtype="bfloat16",
                       backend="xla")
    tp = _packed_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    unpacked = []
    inner = gemm_mod.unpack_operand

    def unpack(p, **kw):
        unpacked.append(p.layout.dtype)
        return inner(p, **kw)

    monkeypatch.setattr(gemm_mod, "unpack_operand", unpack)
    for policy, n_unpacked in (("int8", 1), ("fp32", 1)):
        xj = jnp.asarray(x, jnp.bfloat16 if policy == "int8"
                         else jnp.float32)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
            torch.bfloat16 if policy == "int8" else torch.float32)
        with jcfg.gemm_backend("interpret"), jax.disable_jit():
            want = jmp_dot(xj, jp, policy=policy)
        got = gemm_mod.mp_dot(xt, tp, policy=policy)
        assert len(unpacked) == n_unpacked
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **W.TOL)


def _requests(cls, vocab):
    """Two prompts of one length, one wave (one prefill shape for the
    reference's jit to compile)."""
    rng = np.random.default_rng(3)
    return [cls(uid=i, prompt=rng.integers(2, vocab, (8,)).astype(np.int32),
                max_new_tokens=m) for i, m in enumerate((5, 3))]


def test_wave_engine_tokens_match_reference_packed_int4():
    """llama-vision with int4 payloads under fp32 (whose logits agree to
    1e-4, so no greedy choice flips on a rounding): two requests in one
    wave through both engines (zero image embeddings, as both stub them),
    the same greedy tokens."""
    jm, jp, tm, tp, _ = W.pair("llama-3.2-vision-11b", "fp32",
                               ("pack", "int4"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JEngine(jm, jp, batch_size=2, max_len=32)
        teng = ServeEngine(tm, tp, batch_size=2, max_len=32)
    vocab = tm.cfg.vocab
    want = jeng.generate(_requests(JRequest, vocab))
    got = teng.generate(_requests(Request, vocab))
    assert got == want and sorted(got) == [0, 1]


@pytest.mark.parametrize("arch,args", [
    ("llama-3.2-vision-11b", ["--policy", "int8", "--pack"]),
    ("rwkv6-1.6b", ["--pack", "--pack-format", "int4"]),
    ("recurrentgemma-2b", ["--pack", "--pack-format", "fp8"]),
])
def test_cli_pack_on_the_wave_engine(arch, args, capsys):
    rc = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--engine", "wave", "--requests", "2", "--max-new",
                      "3", "--max-len", "48", *args])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[serve] packed static weights:" in out and "MiB payload" in out
    assert "engine=wave" in out and "req1:" in out
