"""The cross and recurrent architectures under the int8 policy, dense, on
the port's wave path against the JAX package's, on the CPU, at their
smoke sizes (llama-3.2-vision-11b, rwkv6-1.6b, recurrentgemma-2b; the
helpers and the perturbed parameter tree are ``torch_wave_forms.py``'s).

Under the int8 policy every dense GEMM weight stays f32 and both operands
are quantized per tensor at each call (K1 int8), the RWKV LoRA's ``lora_a``
and ``w_lora_a`` too; the fp32 policy's products (the grouped ``lora_b``,
the RG-LRU gates) keep f32 operands (K1's f32 FMA), and RWKV's ``@
w_lora_b`` stays a plain f32 product.  The reference runs its
``interpret`` backend (its Pallas bodies, which the port's kernels port)
op by op (see ``torch_wave_forms.py``).

A prefill quantizes all its tokens' activations with one scale, a decode
step its one token's: under this policy a decode step and a longer
prefill differ by design, in the reference too, so the decode steps are
held to the reference's decode steps, and the caches after them to the
reference's.

rwkv6 and recurrentgemma are held whole; llama-vision's cross block is
held alone (its model under int8 is held packed, in
``test_torch_wave_forms_packed.py``: a whole model op by op on the
interpret backend takes minutes when the suite's workers share the
CPU).

Tolerances: logits and caches atol = rtol = 3e-2, as the packed and sparse
serving tests (``TOL``); rwkv6's logits come out equal to the
reference's, recurrentgemma's local attention rounds its softmax weights
differently (the reference's oracle in bf16) and moves them by under
1e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch_wave_forms as W  # noqa: E402

from repro.core import config as jcfg  # noqa: E402

from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.transformer import build_model as tbuild  # noqa: E402,E501


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_int8_prefill_and_decode_match_reference(arch):
    """Two 8-token rows (one left-padded), then two decode steps: logits
    and every cache tensor against the reference's interpret backend."""
    jm, jp, tm, tp, _ = W.pair(arch, "int8")
    pairs, tc, jc, _, _ = W.run_both(jm, jp, tm, tp, backend="interpret",
                                     eager=True)
    W.assert_pairs_close(pairs)
    for got, want, path in W.cache_leaves(tc, jc, tm.cfg):
        want = np.asarray(want.astype(np.float32))
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_allclose(got.float().numpy(), want, **W.TOL,
                                   err_msg=str(path))


def test_int8_cross_block_matches_reference():
    """llama-vision's cross block (the carried fifth layer, gates opened)
    under the int8 policy over a prompt and the image states, then two
    decode steps against its cached image K/V: outputs and the cache
    against the reference's interpret backend.  (The whole model under
    int8 runs packed in ``test_torch_wave_forms_packed.py``; its four
    dense layers are the attention kinds' blocks.)"""
    from repro.models import blocks as JB
    from repro_torch.models import blocks as TB
    jm, jp, tm, tp, _ = W.pair("llama-3.2-vision-11b", "int8")
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["stack"][4])
    tl = tp["layers"][4]
    assert "gate_attn" in tl and float(tl["gate_attn"]) != 0.0
    rng = np.random.default_rng(9)
    cfg = tm.cfg
    x = rng.standard_normal((2, 9, cfg.d_model))
    img = rng.standard_normal((2, cfg.n_image_tokens, cfg.d_model))
    bf = jnp.bfloat16

    def both(a):
        j = jnp.asarray(a, bf)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            torch.bfloat16)

    (xj, xt), (ij, it) = both(x), both(img)
    jctx = {"cfg": jm.cfg, "policy": "int8", "collect_cache": True,
            "cache_dtype": bf, "cross_states": ij}
    tctx = {"cfg": cfg, "policy": "int8", "fused": True,
            "collect_cache": True, "cache_dtype": torch.bfloat16,
            "cross_states": it}
    with jcfg.gemm_backend("interpret"), jax.disable_jit():
        jy, _, jc = JB.cross_fwd(jl, xj[:, :7], jctx)
        jd = [JB.cross_decode(jl, xj[:, i:i + 1], jc, jctx)[0]
              for i in (7, 8)]
    ty, _, tc = TB.cross_fwd(tl, xt[:, :7], tctx)
    td = [TB.cross_decode(tl, xt[:, i:i + 1], tc, tctx) for i in (7, 8)]
    for got, want in [(ty, jy), *zip(td, jd), (tc["k"], jc["k"]),
                      (tc["v"], jc["v"])]:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **W.TOL)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_int8_storage_and_caches_are_the_references(arch):
    """Dense GEMM weights stay f32 (quantized per call), the fp32 policy's
    leaves f32, the embedding bf16; the caches and recurrent states have
    the reference's shapes and dtypes under int8."""
    jm, _, tm, tp, _ = W.pair(arch, "int8")
    for layer in tp["layers"]:
        for name in ("wq", "wr", "w_x", "lora_a", "w_lora_a", "lora_b",
                     "w_lora_b", "w_gate_r", "w_gate_i"):
            if name in layer:
                assert layer[name].dtype == torch.float32, name
        if "xattn" in layer:
            assert layer["xattn"]["wk"].dtype == torch.float32
            assert layer["mlp"]["w_down"].dtype == torch.float32
    assert tp["embed"].dtype == torch.bfloat16
    want = jm.init_caches(2, 16)
    got = tm.init_caches(2, 16)
    for t, j, path in W.cache_leaves(got, want, tm.cfg):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path


@pytest.mark.parametrize("arch", W.ARCHS)
def test_int8_launches_are_what_chip_smoke_counts(arch, monkeypatch):
    """A prefill and a decode step of the int8 smoke model number the
    wrapper calls ``chip_smoke._want_wave_launches`` asserts on the card;
    every 2-D product but the f32 gates takes int8 A (``lora_a`` and
    ``w_lora_a`` too), every grouped one (the LoRA) f32 A on the FMA
    design."""
    tm = tbuild(tcb.get(arch, smoke=True), policy="int8", device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    calls = W.check_counts(monkeypatch, tm, tp)
    for c in calls:
        if c == "k4":
            continue
        assert c.kernel == "k1"
        if c.grouped or c.f32_fma:
            assert c.a_dtype == torch.float32 and c.f32_fma
        else:
            assert c.a_dtype == torch.int8


@pytest.mark.parametrize("arch", W.ARCHS)
def test_cli_int8_policy_on_the_wave_engine(arch, capsys):
    rc = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--engine", "wave", "--policy", "int8", "--requests",
                      "2", "--max-new", "3", "--max-len", "48"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "policy=int8, engine=wave" in out
    assert "req0:" in out and "req1:" in out
