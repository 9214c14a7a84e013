"""The PyTorch port's serving path against the JAX package's, on the CPU.

``params_from_jax`` carries a JAX parameter tree across, so both packages
compute the same function: one ``paged_step`` must give the same logits on
the live rows, and the continuous engine the same greedy tokens.  The JAX
side runs its default CPU backend (XLA, with ``paged_attention_ref``).

Tolerances: fp32 logits atol = rtol = 1e-4 (summation order only).  bf16
logits atol = rtol = 3e-2: every GEMM output and the residual stream are
rounded to bf16 in both, the reference's attention oracle also rounds the
softmax weights to bf16 before P·V where the port keeps them in f32 (as the
TPU and CUDA kernels do), and a bf16 ulp at the logits' scale (about 1) is
2**-8.  Idle rows are excluded: the oracle does not zero V for them.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.kv_cache import PagedKVCache as JKV  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    build_model as tbuild, params_from_jax,
)
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import PagedKVCache  # noqa: E402

TOL = {"fp32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=3e-2, rtol=3e-2)}

# A mixed pattern (two unit kinds, scanned, plus an unscanned tail layer)
# with an odd vocab exercises params_from_jax's unstacking and the padded-
# vocab mask; both packages share the ArchConfig fields.
MIXED = dict(block_pattern=("dense", "attn_local", "dense"),
             local_attn_window=5, vocab=500, n_layers=3)


def _configs(arch):
    if arch == "mixed":
        j = dataclasses.replace(jcb.get("phi3-mini-3.8b", smoke=True),
                                name="mixed", **MIXED)
        t = dataclasses.replace(tcb.get("phi3-mini-3.8b", smoke=True),
                                name="mixed", **MIXED)
        return j, t
    return jcb.get(arch, smoke=True), tcb.get(arch, smoke=True)


def _pair(arch, policy, seed=0):
    jcfg, tcfg = _configs(arch)
    jm = jbuild(jcfg, policy=policy, remat=False)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = tbuild(tcfg, policy=policy, device="cpu")
    tp = tm.load_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tcfg))
    return jm, jp, tm, tp


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "h2o-danube3-4b",
                                  "mixed"])
def test_paged_step_logits_match_reference(arch, policy):
    jm, jp, tm, tp = _pair(arch, policy)
    ps, n_pages, b, c, w = 8, 12, 3, 8, 5
    rng = np.random.default_rng(0)
    bt = np.zeros((b, w), np.int32)
    bt[0, :3] = [3, 5, 7]
    bt[1, :2] = [2, 9]
    q_start = np.array([c, 0, 0], np.int32)       # row 2 is idle
    n_valid = np.array([c, 5, 0], np.int32)       # row 1: 3 dead columns
    toks = rng.integers(2, jm.cfg.vocab, (b, c)).astype(np.int32)
    # A first chunk of the same width fills row 0's context (positions
    # 0..c-1) in both pools.
    pre = rng.integers(2, jm.cfg.vocab, (b, c)).astype(np.int32)
    zeros, first = np.zeros(b, np.int32), np.array([c, 0, 0], np.int32)

    jc = jm.init_paged_caches(n_pages, ps)
    step = jax.jit(jm.paged_step)
    _, jc = step(jp, jnp.asarray(pre), jc, jnp.asarray(bt),
                 jnp.asarray(zeros), jnp.asarray(first))
    want, _ = step(jp, jnp.asarray(toks), jc, jnp.asarray(bt),
                   jnp.asarray(q_start), jnp.asarray(n_valid))
    want = np.asarray(want.astype(jnp.float32))

    tc = tm.init_paged_caches(n_pages, ps)
    tt = torch.from_numpy
    tm.paged_step(tp, tt(pre), tc, tt(bt), tt(zeros), tt(first))
    got, tc2 = tm.paged_step(tp, tt(toks), tc, tt(bt), tt(q_start),
                             tt(n_valid))
    assert tc2 is tc                                # pools updated in place
    assert got.shape == want.shape == (b, tm.vocab_padded)
    got = got.float().numpy()
    live = n_valid > 0
    np.testing.assert_allclose(got[live], want[live], **TOL[policy])
    assert np.isfinite(got).all()
    if tm.vocab_padded != tm.cfg.vocab:             # masked vocab padding:
        pad_t, pad_j = got[:, tm.cfg.vocab:], want[:, tm.cfg.vocab:]
        assert (pad_t == pad_j).all() and (pad_t < -9e29).all()  # -1e30


# ============================== engine e2e ===================================

@pytest.fixture(scope="module")
def fp32_pair():
    return _pair("phi3-mini-3.8b", "fp32")


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(2, vocab, (n,)).astype(
        np.int32)


def _serve_both(fp32_pair, prompts, max_new, **engine_kw):
    jm, jp, tm, tp = fp32_pair
    out = []
    for eng in (JEngine(jm, jp, **engine_kw), ServeEngine(tm, tp,
                                                          **engine_kw)):
        done = {}
        for i, p in enumerate(prompts):
            eng.add_request(p, max_new_tokens=max_new, uid=i)
        steps = 0
        while eng.pending:
            for r in eng.step():
                done[r.uid] = r.out_tokens
            steps += 1
            assert steps < 400
        eng.kv.check_invariants()
        out.append((done, eng))
    return out


def test_engine_greedy_tokens_match_reference_with_prefix_sharing(fp32_pair):
    """Four requests through two slots; requests 2 and 3 reuse request 0's
    indexed prompt pages.  Same greedy tokens, same sharing."""
    vocab = fp32_pair[0].cfg.vocab
    shared = _prompt(vocab, 20, seed=7)
    prompts = [shared, _prompt(vocab, 11, seed=8), shared,
               np.concatenate([shared[:16], _prompt(vocab, 5, seed=9)])]
    (jdone, jeng), (tdone, teng) = _serve_both(
        fp32_pair, prompts, 6, max_len=64, max_batch=2, page_size=8)
    assert sorted(tdone) == [0, 1, 2, 3]
    assert tdone == jdone
    assert teng.kv.stats.prefix_hit_tokens == jeng.kv.stats.prefix_hit_tokens
    assert teng.kv.stats.prefix_hit_tokens >= 32
    assert tdone[2] == tdone[0]                     # sharing is transparent
    phases = [s.phase for s in teng.step_telemetry]
    assert phases == [s.phase for s in jeng.step_telemetry]
    assert sum(s.tokens for s in teng.step_telemetry) == 4 * 6


def test_engine_preemption_matches_reference(fp32_pair):
    """A pool too small for both requests forces preemption (recompute);
    both packages preempt at the same steps and emit the same tokens."""
    vocab = fp32_pair[0].cfg.vocab
    prompts = [_prompt(vocab, 10, seed=4), _prompt(vocab, 10, seed=5)]
    (jdone, jeng), (tdone, teng) = _serve_both(
        fp32_pair, prompts, 16, max_len=64, max_batch=2, page_size=8,
        max_pages=8)
    assert tdone == jdone and all(len(v) == 16 for v in tdone.values())
    tpre = [s.preemptions for s in teng.step_telemetry]
    assert sum(tpre) > 0
    assert tpre == [s.preemptions for s in jeng.step_telemetry]


def test_warm_prefixes_then_generate_matches_cold(fp32_pair):
    _, _, tm, tp = fp32_pair
    vocab = tm.cfg.vocab
    sys_prompt = _prompt(vocab, 20, seed=11)
    reqs = [np.concatenate([sys_prompt, _prompt(vocab, 4, seed=12 + i)])
            for i in range(2)]
    cold = ServeEngine(tm, tp, max_len=64, max_batch=2, page_size=8)
    want = cold.generate([Request(uid=i, prompt=p, max_new_tokens=4)
                          for i, p in enumerate(reqs)])
    warm = ServeEngine(tm, tp, max_len=64, max_batch=2, page_size=8)
    assert warm.warm_prefixes([sys_prompt[:4]]) == 0   # shorter than a page
    assert warm.warm_prefixes([sys_prompt]) == 2       # 16 of 20 tokens
    assert warm.step_telemetry == []
    got = warm.generate([Request(uid=i, prompt=p, max_new_tokens=4)
                         for i, p in enumerate(reqs)])
    assert got == want
    assert warm.step_telemetry[-1].prefix_hit_tokens == 32
    assert all(s.kv_bytes < s.kv_bytes_dense for s in warm.step_telemetry)


def test_kv_cache_copy_matches_reference_allocator():
    """The port's own PagedKVCache makes the reference's decisions: same
    tables, prefix hits, evictions and free pages for one op sequence."""
    rng = np.random.default_rng(13)
    p1 = rng.integers(0, 99, 13)
    p2 = np.concatenate([p1[:8], rng.integers(0, 99, 6)])
    caches = (JKV(7, 4), PagedKVCache(7, 4))
    seen = []
    for kv in caches:
        log = []
        kv.allocate("a")
        assert kv.ensure("a", len(p1))
        kv.register_prefix("a", p1)
        pages, toks = kv.match_prefix(p2)
        kv.allocate("b", pages, toks)
        log.append((kv.table("a"), kv.table("b"), toks))
        log.append(kv.ensure("b", 30))                 # needs 6 pages: no
        kv.free_seq("a")
        log.append(kv.ensure("b", 20))                 # evicts a prefix
        log.append((kv.table("b"), kv.free_pages, kv.stats.evictions,
                    kv.stats.prefix_hit_tokens, kv.prefix_entries,
                    kv.block_table_row("b", 6).tolist()))
        kv.check_invariants()
        seen.append(log)
    assert seen[0] == seen[1]
