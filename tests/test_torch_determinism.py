"""The backward of the two gathers of a training step that several rows
share, on the CPU: the MoE dispatch gather (``models/blocks.py::
DispatchGather``) and the embedding (``F.embedding`` in ``LM._embed``).

On the card autograd through ``torch.gather`` and through indexing
(``index_put_`` with accumulate) sums the rows that meet in one token in
no fixed order, so that a training step did not repeat itself bit for bit.
``DispatchGather`` sums a token's k slots in choice order in f32 and rounds
once; ``F.embedding``'s backward sums each id's rows in a fixed order.

* With integer-valued upstream gradients every summation order is exact:
  both backward passes are bit-equal to autograd through ``torch.gather``
  and through indexing, in f32 and bf16, at granite's smoke shapes (8
  experts, top-4, d 128) with dropped pairs and empty slots.
* With random gradients the dispatch gather's backward is within one
  rounding of the output dtype of the exact sum (float64), and autograd
  through ``torch.gather`` within the roundings of its own sum: one a
  term (bf16 accumulates in bf16).
* The forward bits do not change.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as cb  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    MOE_TRAIN_CAPACITY, build_model,
)

SMOKE = cb.get("granite-moe-1b-a400m", smoke=True)
DTYPES = [torch.float32, torch.bfloat16]
EPS = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}  # unit roundoff


def _routing(b, s, seed):
    """(src, dest_tok, k, e·cap) of a skewed top-k routing of ``b`` x ``s``
    tokens over the smoke config's experts: experts 0 and 1 draw more pairs
    than their capacity (dropped pairs), the others fewer (empty slots)."""
    e, k = SMOKE.n_experts, SMOKE.experts_per_token
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, s, e)).astype(np.float32)
    logits[..., :2] += 2.0
    gates = torch.softmax(torch.from_numpy(logits), dim=-1)
    _, topi = blocks.moe_topk(gates, k)
    cap = blocks.moe_capacity(MOE_TRAIN_CAPACITY, k, s, e)
    src, dest_tok = blocks.moe_dispatch(topi, e, cap)
    assert (dest_tok == e * cap).any(), "no dropped pair"
    assert (src == s).any(), "no empty slot"
    return src, dest_tok, k, e * cap


def _draw(rng, shape, dtype, integer):
    a = (rng.integers(-4, 5, shape) if integer
         else rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


def _dispatch_grads(x, src, dest_tok, k, g):
    """-> (x's gradient through DispatchGather, through torch.gather)."""
    b, _, d = x.shape
    xa = x.clone().requires_grad_(True)
    (new,) = torch.autograd.grad(
        blocks.DispatchGather.apply(xa, src, dest_tok, k), xa, g)
    xb = x.clone().requires_grad_(True)
    tok_pad = torch.cat([xb, xb.new_zeros(b, 1, d)], dim=1)
    old_buf = torch.gather(tok_pad, 1, src[..., None].expand(*src.shape, d))
    (old,) = torch.autograd.grad(old_buf, xb, g)
    return new, old


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s", [(2, 16), (4, 32)])
def test_dispatch_forward_is_the_gather(dtype, b, s):
    src, dest_tok, k, _ = _routing(b, s, seed=s)
    x = _draw(np.random.default_rng(1), (b, s, SMOKE.d_model), dtype, False)
    tok_pad = torch.cat([x, x.new_zeros(b, 1, SMOKE.d_model)], dim=1)
    want = torch.gather(tok_pad, 1,
                        src[..., None].expand(*src.shape, SMOKE.d_model))
    assert torch.equal(blocks.DispatchGather.apply(x, src, dest_tok, k),
                       want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s", [(2, 16), (4, 32)])
def test_dispatch_backward_is_bit_equal_on_integers(dtype, b, s):
    src, dest_tok, k, slots = _routing(b, s, seed=s)
    rng = np.random.default_rng(2)
    x = _draw(rng, (b, s, SMOKE.d_model), dtype, True)
    g = _draw(rng, (b, slots, SMOKE.d_model), dtype, True)
    new, old = _dispatch_grads(x, src, dest_tok, k, g)
    assert new.dtype == dtype and torch.equal(new, old)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s", [(2, 16), (4, 32)])
def test_dispatch_backward_within_one_rounding(dtype, b, s):
    src, dest_tok, k, slots = _routing(b, s, seed=s)
    rng = np.random.default_rng(3)
    d = SMOKE.d_model
    x = _draw(rng, (b, s, d), dtype, False)
    g = _draw(rng, (b, slots, d), dtype, False)
    new, old = _dispatch_grads(x, src, dest_tok, k, g)
    rows = torch.cat([g, g.new_zeros(b, 1, d)], dim=1).double()
    rows = torch.gather(rows, 1, dest_tok[..., None].expand(b, s * k, d))
    rows = rows.reshape(b, s, k, d)
    exact, size = rows.sum(2), rows.abs().sum(2)
    # One rounding to the dtype, plus the f32 sum's k - 1 roundings.
    bound = EPS[dtype] * exact.abs() + k * 2.0 ** -24 * size
    assert ((new.double() - exact).abs() <= bound).all()
    # torch.gather's backward rounds each term's add to the dtype.
    assert ((old.double() - exact).abs() <= k * EPS[dtype] * size).all()


def _embed_grads(table, tokens, g):
    """-> (the table's gradient through F.embedding, through indexing)."""
    ta = table.clone().requires_grad_(True)
    (new,) = torch.autograd.grad(
        torch.nn.functional.embedding(tokens, ta), ta, g)
    tb = table.clone().requires_grad_(True)
    (old,) = torch.autograd.grad(tb[tokens], tb, g)
    return new, old


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s", [(2, 16), (4, 32)])
def test_embedding_backward_is_bit_equal_on_integers(dtype, b, s):
    """Ids drawn from a few rows, so that many tokens meet in one."""
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, 12, (b, s)))
    table = _draw(rng, (SMOKE.vocab, SMOKE.d_model), dtype, True)
    g = _draw(rng, (b, s, SMOKE.d_model), dtype, True)
    new, old = _embed_grads(table, tokens, g)
    assert new.dtype == dtype and torch.equal(new, old)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embedding_backward_within_one_rounding(dtype):
    rng = np.random.default_rng(5)
    b, s, d = 4, 32, SMOKE.d_model
    tokens = torch.from_numpy(rng.integers(0, 12, (b, s)))
    table = _draw(rng, (SMOKE.vocab, d), dtype, False)
    g = _draw(rng, (b, s, d), dtype, False)
    new, old = _embed_grads(table, tokens, g)
    exact = torch.zeros(SMOKE.vocab, d, dtype=torch.float64).index_add_(
        0, tokens.reshape(-1), g.double().reshape(-1, d))
    size = torch.zeros_like(exact).index_add_(
        0, tokens.reshape(-1), g.double().abs().reshape(-1, d))
    n = int(torch.bincount(tokens.reshape(-1)).max())
    for got in (new, old):
        assert ((got.double() - exact).abs() <= n * EPS[dtype] * size).all()


def test_embed_uses_the_embedding_gather():
    """``LM._embed``'s rows are the table's rows, bit for bit, and its
    backward is F.embedding's."""
    model = build_model(SMOKE, policy="fp32", device="cpu")
    params = model.init_train(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, SMOKE.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    table = params["embed"].detach().requires_grad_(True)
    x = model._embed(dict(params, embed=table), tokens)
    assert torch.equal(x, table.detach()[tokens].to(x.dtype))
    names, fn = [], x.grad_fn
    while fn is not None:
        names.append(fn.name())
        fn = fn.next_functions[0][0] if fn.next_functions else None
    assert "EmbeddingBackward0" in names
