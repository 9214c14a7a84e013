"""Parity of the PyTorch port's paged attention (CPU: K5's plain version)
with the JAX package's Pallas K5 (``paged_flash_attention``) in interpret
mode, and of the layers around it (paged KV write, RMSNorm, RoPE).

The pools hold GQA 4:2 heads of width 24 (not a power of two).  Every case
has ragged lengths, a request whose chunk is partly dead padding, dead
block-table slots pointing at scratch page 0 (filled with NaN, so a read of
it that reaches the output shows), and one idle request (length 0).  Only
live query rows (position < length) are compared; idle rows must be finite
(the port's are exactly 0, as the kernel's are).

Tolerances: f32 atol = rtol = 2e-5 (online against one-pass softmax, and
another summation order); bf16 outputs compare in f32 within one bf16 ulp
of the values (atol = rtol = 1.6e-2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels.flash_attention import \
    paged_flash_attention as jax_paged_flash  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

B, HKV, G, D, PS, W = 3, 2, 2, 24, 4, 5
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=1.6e-2, rtol=1.6e-2)}


def _setup(rng, c, dtype="float32"):
    """Pool, tables and chunk positions: request 0 runs a full chunk deep
    into its context, request 1 a short chunk (dead rows past n_valid),
    request 2 is idle."""
    if c == 1:
        q_start, n_valid = np.array([16, 2, 0]), np.array([1, 1, 0])
    else:
        q_start, n_valid = np.array([20 - c - 3, 0, 0]), np.array([c, 3, 0])
    q_start, n_valid = q_start.astype(np.int32), n_valid.astype(np.int32)
    lengths = q_start + n_valid
    n_pages = 1 + B * W
    kp = rng.standard_normal((n_pages, HKV, PS, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, HKV, PS, D)).astype(np.float32)
    kp[0] = np.nan
    vp[0] = np.nan
    perm = rng.permutation(np.arange(1, n_pages)).reshape(B, W)
    bt = np.zeros((B, W), np.int32)
    for i, ln in enumerate(lengths):
        used = -(-int(ln) // PS)
        bt[i, :used] = perm[i, :used]
    q = rng.standard_normal((B, HKV * G, c, D)).astype(np.float32)
    if dtype == "bfloat16":
        q, kp, vp = (a.astype(ml_dtypes.bfloat16) for a in (q, kp, vp))
    return q, kp, vp, bt, q_start, n_valid, lengths


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _live(q_start, n_valid, c):
    """(B, C) mask of query rows whose position is below the length."""
    return np.arange(c)[None, :] < n_valid[:, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,window", [(1, None), (8, None), (1, 6), (8, 6)])
def test_paged_attention_matches_interpret_kernel(c, window, dtype):
    rng = np.random.default_rng(100 * c + (window or 0))
    q, kp, vp, bt, q_start, n_valid, lengths = _setup(rng, c, dtype)
    want = np.asarray(jax_paged_flash(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, q_start, lengths)),
        causal=True, window=window, interpret=True)).astype(np.float32)
    got = tattn.paged_attention(
        *(_torch(a) for a in (q, kp, vp, bt, q_start, lengths)),
        causal=True, window=window)
    assert got.dtype == _torch(q).dtype
    got = got.float().numpy()
    live = _live(q_start, n_valid, c)
    sel = np.broadcast_to(live[:, None, :, None], got.shape)
    np.testing.assert_allclose(got[sel], want[sel], **TOL[dtype])
    idle = lengths == 0
    assert np.isfinite(want[idle]).all()
    assert (got[idle] == 0).all()


def test_paged_attention_ref_matches_reference_ref():
    """The port's gather oracle keeps the reference's numerics: p cast to
    V's dtype, V not zeroed past the length (so it is compared with a
    finite scratch page, idle rows included)."""
    rng = np.random.default_rng(3)
    q, kp, vp, bt, q_start, n_valid, lengths = _setup(rng, 8)
    kp[0] = 5.0
    vp[0] = -3.0
    want = np.asarray(jattn.paged_attention_ref(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, q_start, lengths)),
        window=6))
    got = tattn.paged_attention_ref(
        *(_torch(a) for a in (q, kp, vp, bt, q_start, lengths)),
        window=6).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_paged_kv_write_matches_reference():
    """Valid rows land where the reference puts them; dead rows touch only
    the scratch page (whose content either package may leave different)."""
    rng = np.random.default_rng(4)
    c = 6
    n_pages = 1 + B * W
    kp = rng.standard_normal((n_pages, HKV, PS, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, HKV, PS, D)).astype(np.float32)
    bt = (1 + np.arange(B * W).reshape(B, W)).astype(np.int32)
    q_start = np.array([2, 9, 0], np.int32)
    n_valid = np.array([6, 2, 0], np.int32)
    k_new = rng.standard_normal((B, HKV, c, D)).astype(np.float32)
    v_new = rng.standard_normal((B, HKV, c, D)).astype(np.float32)
    wk, wv = jattn.paged_kv_write(
        *(jnp.asarray(a) for a in (kp, vp, k_new, v_new, bt, q_start,
                                    n_valid)))
    tk, tv = _torch(kp.copy()), _torch(vp.copy())
    out = tattn.paged_kv_write(tk, tv, *(_torch(a) for a in (
        k_new, v_new, bt, q_start, n_valid)))
    assert out[0] is tk and out[1] is tv          # updated in place
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(wk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(wv)[1:])
    # 6 + 2 valid rows changed real pages; everything else stayed.
    changed = (tk.numpy()[1:] != kp[1:]).any(axis=(1, 3)).sum()
    assert changed == 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_scales_by_one_plus_weight(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 40)).astype(np.float32)
    w = (0.1 * rng.standard_normal(40)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jlayers.rmsnorm(jnp.asarray(x).astype(jdt),
                                      jnp.asarray(w))).astype(np.float32)
    got = tlayers.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    # Zero weight (the initial value) is the identity scale, not zero.
    ones = tlayers.rmsnorm(torch.ones(2, 8), torch.zeros(8))
    np.testing.assert_allclose(ones.numpy(), np.ones((2, 8)), rtol=1e-5)


def test_rope_split_halves_with_paged_positions():
    """Split-halves RoPE at per-row (B, T) positions, as paged_step feeds
    it (tables built to W*ps, positions clipped to W*ps - 1)."""
    rng = np.random.default_rng(6)
    hd, max_pos = 24, 20
    x = rng.standard_normal((2, 3, 4, hd)).astype(np.float32)
    pos = np.clip(np.array([[0, 7, 19, 25], [3, 4, 5, 6]]), 0, max_pos - 1)
    jc, js = jlayers.rope_frequencies(hd, max_pos, 10000.0)
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jc, js,
                                         jnp.asarray(pos)))
    tc, ts = tlayers.rope_frequencies(hd, max_pos, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    got = tlayers.apply_rope(torch.from_numpy(x), tc, ts,
                             torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
