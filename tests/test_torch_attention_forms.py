"""The reference's XLA attention forms in the port (``models/attention.py``:
``chunked_attention``, ``banded_window_attention``) and the form whose
gradient ``attention_core`` takes (``backward_form``), on the CPU.

Forward and ``jax.grad`` parity against ``repro.models.attention`` in f32
at D 8-16, H 2-4 with GQA: outputs within 1e-5, gradients within 1e-4
(the two sum in other orders).  The chunked cases cover the triangular
schedule with equal chunks (maskless below the diagonal) and with unequal
ones, the rectangular schedule (cross lengths, no causality) and
zero-padded tails; the banded ones a tail, one block and GQA.

Two faults of the reference are pinned (ROADMAP C): its triangular
schedule visits kv chunk ``j <= i``, which misses keys when ``q_chunk >
kv_chunk``; and its ``attention_core`` on XLA runs ``chunked_attention``,
which takes no window, for a causal window with ``2048 < t <= 2 *
window``.  The port's gradient there is that of windowed attention.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as RA  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, b, h, hkv, tq, d, tk=None):
    rng = np.random.default_rng(seed)
    tk = tk or tq
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, tk, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    return q, k, v, do


def _both(jfn, tfn, q, k, v, do):
    """-> (port output, reference output, port grads, reference grads)."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tfn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    js = [jnp.asarray(a) for a in (q, k, v)]
    want, vjp = jax.vjp(jfn, *js)
    jgrads = vjp(jnp.asarray(do))
    return out.detach().numpy(), np.asarray(want), grads, jgrads


def _check(got, want, grads, jgrads):
    np.testing.assert_allclose(got, want, **FWD)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD)


# (b, h, hkv, tq, tk, d, causal, q_chunk, kv_chunk)
CHUNKED = {
    "triangular-maskless-gqa-tail": (2, 4, 1, 37, None, 16, True, 8, 8),
    "triangular-unequal-chunks": (1, 2, 2, 37, None, 8, True, 4, 8),
    "rectangular-cross-causal-tail": (1, 4, 2, 21, 45, 8, True, 8, 16),
}


@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_chunked_attention_matches_the_reference(case):
    b, h, hkv, tq, tk, d, causal, qc, kc = CHUNKED[case]
    q, k, v, do = _inputs(sorted(CHUNKED).index(case), b, h, hkv, tq, d, tk)
    kw = dict(causal=causal, q_chunk=qc, kv_chunk=kc)
    _check(*_both(lambda *a: RA.chunked_attention(*a, **kw),
                  lambda *a: TA.chunked_attention(*a, **kw), q, k, v, do))


# (b, h, hkv, t, d, window)
BANDED = {"gqa-tail": (2, 4, 1, 37, 16, 8), "one-block": (1, 2, 2, 5, 8, 8)}


@pytest.mark.parametrize("case", sorted(BANDED))
def test_banded_window_attention_matches_the_reference(case):
    b, h, hkv, t, d, w = BANDED[case]
    q, k, v, do = _inputs(10 + sorted(BANDED).index(case), b, h, hkv, t, d)
    _check(*_both(lambda *a: RA.banded_window_attention(*a, window=w),
                  lambda *a: TA.banded_window_attention(*a, window=w),
                  q, k, v, do))
    dense = TA.dense_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True, window=w)
    got = TA.banded_window_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), window=w)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **FWD)


def test_the_reference_triangular_schedule_misses_keys_past_its_chunk():
    """q_chunk 8 > kv_chunk 4: the reference visits kv chunks j <= i and
    drops the keys of chunks i + 1 .. 2i + 1; the port visits every kv
    chunk its queries can see and equals dense attention."""
    q, k, v, _ = _inputs(0, 1, 2, 2, 32, 8)
    dense = TA.dense_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    got = TA.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               q_chunk=8, kv_chunk=4)
    want = np.asarray(RA.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v)), q_chunk=8, kv_chunk=4))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **FWD)
    assert np.abs(want - dense.numpy()).max() > 0.5


@pytest.mark.parametrize("tq,tk,causal,window,form", [
    (128, 128, True, None, "dense"),
    (128, 128, True, 2048, "dense"),      # recurrentgemma training, seq 128
    (128, 128, True, 64, "dense"),        # t = 2 * window
    (129, 129, True, 64, "banded"),
    (2048, 2048, True, None, "dense"),
    (2049, 2049, True, None, "chunked"),
    (16384, 16384, True, None, "chunked"),
    (3000, 3000, True, 2048, "banded"),   # the reference's pick: chunked
    (12288, 12288, True, 4096, "banded"),
    (32, 1600, False, None, "dense"),     # cross-attention
    (4096, 4096, False, None, "chunked"),
    (4096, 4096, False, 512, "dense"),
])
def test_backward_form(tq, tk, causal, window, form):
    assert TA.backward_form(tq, tk, causal=causal, window=window) == form


@pytest.mark.parametrize("case", [
    dict(h=4, hkv=2, tq=128, tk=128, causal=True, window=None),
    dict(h=4, hkv=2, tq=96, tk=96, causal=True, window=64),
    dict(h=2, hkv=1, tq=16, tk=40, causal=False, window=None),
])
def test_attention_core_gradient_at_short_lengths_is_dense_bit_for_bit(case):
    """Where the pick is dense (every training path at seq 128), the
    gradient is the one the port took before the forms came: autograd
    through ``dense_attention``, bit for bit."""
    q, k, v, do = _inputs(3, 1, case["h"], case["hkv"], case["tq"], 8,
                          case["tk"])
    kw = dict(causal=case["causal"], window=case["window"])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(TA.attention_core(*ts, **kw), ts,
                              torch.from_numpy(do))
    want = torch.autograd.grad(TA.dense_attention(*ts, **kw), ts,
                               torch.from_numpy(do))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_windowed_gradient_past_the_dense_limit_is_windowed():
    """2048 < t <= 2 * window: the port's gradient (the banded form) equals
    windowed dense attention's; the reference's XLA ``attention_core``
    (chunked, no window) computes unwindowed attention there."""
    t, w = 2100, 2048
    q, k, v, do = _inputs(0, 1, 1, 1, t, 8)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(
        TA.attention_core(*ts, causal=True, window=w), ts,
        torch.from_numpy(do))
    want = torch.autograd.grad(
        TA.dense_attention(*ts, causal=True, window=w), ts,
        torch.from_numpy(do))
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wg.numpy(), **GRAD)
    ref = np.asarray(RA.attention_core(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, window=w,
        backend="xla"))
    windowed = TA.dense_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=True, window=w).numpy()
    plain = TA.dense_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True).numpy()
    assert np.abs(ref - windowed).max() > 1e-2
    np.testing.assert_allclose(ref, plain, **FWD)


def test_long_unwindowed_gradient_is_the_chunked_form():
    """t = 2100 with no window: the chunked form (non-causal here, so the
    rectangular schedule over 1024-key chunks), held to the reference's
    XLA ``attention_core`` (chunked too) and its ``jax.grad``."""
    q, k, v, do = _inputs(1, 1, 2, 1, 2100, 8)
    _check(*_both(
        lambda *a: RA.attention_core(*a, causal=False, backend="xla"),
        lambda *a: TA.attention_core(*a, causal=False), q, k, v, do))
