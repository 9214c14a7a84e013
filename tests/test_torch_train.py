"""Training in the port against the JAX package: the whole train step,
the loop, the optimizer, the pipeline, the checkpointer and the CLI.

The port runs on CPU tensors (plain versions of every kernel).  The whole
step is held against the reference's jitted ``make_train_step`` on its
``xla`` backend -- the one whose attention differentiates (its flash
kernel has no VJP) -- under fp32, where the two compute the same function
up to f32 summation order: MoE top-k ties flip under bf16 on the CPU.
Both start from the same weights (the reference's draw, carried over by
``params_from_jax``) and see the same batches (the synthetic pipeline is a
pure function of the seed).

Tolerances (fp32): the loss rtol 1e-5 and the grad norm rtol 1e-4 (f32
sums in another order, through a few layers).  Per-leaf gradients atol
1e-5 + rtol 1e-3 of the leaf's largest |g| (``_close_rel``): a gradient
is a sum of many products whose order differs, so its error scales with
the largest terms of its leaf, not with each element.  Parameters after 3
AdamW steps atol 2e-5: step 1 has lr 0 (the cosine warm-up starts at 0),
steps 2 and 3 move each weight by at most lr · (1 + decay) = 1.1e-3, and
Adam's update m / sqrt(v) keeps the relative error of the gradient -- up
to 1e-3 of the leaf's largest |g| for an element whose gradient is that
much smaller than the largest -- so a moved weight agrees to about 1e-3
of 1.1e-3.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as jadamw_init  # noqa: E402
from repro.train.train_step import make_train_step as jmake_step  # noqa: E402,E501
from repro_torch.checkpoint.checkpointing import Checkpointer  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, device_batch  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    StragglerDetector,
)
from repro_torch.kernels import mpgemm as tk  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    build_model as tbuild, params_from_jax,
)
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig, AdamWState, adamw_init, cosine_schedule, decay_mask,
    tree_leaves,
)
from repro_torch.packing import pack as tpack  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    _value_and_grad, make_eval_step, make_train_step, pick_microbatches,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


def _tiny_shape():
    return ShapeConfig("tiny", seq_len=32, global_batch=4, kind="train")


NEW_KINDS = ["llama-3.2-vision-11b", "rwkv6-1.6b", "recurrentgemma-2b"]


def _pair(arch, policy="fp32", seed=0):
    """The reference's model and draw, the port's model and the same
    weights as f32 masters.  A VLM's cross gates are drawn 0, which closes
    both branches of its cross block (every gradient there exactly 0):
    both packages start from gates 0.7 and -0.4 instead."""
    jc, tc = jcb.get(arch, smoke=True), tcb.get(arch, smoke=True)
    jm = jbuild(jc, policy=policy)
    jp = jm.init(jax.random.PRNGKey(seed))
    for unit in jp["stack"] + jp["tail"]:
        if "gate_attn" in unit:
            unit["gate_attn"] = jnp.full_like(unit["gate_attn"], 0.7)
            unit["gate_mlp"] = jnp.full_like(unit["gate_mlp"], -0.4)
    tm = tbuild(tc, policy=policy, device="cpu")
    tp = tm.train_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tc))
    return jm, jp, tm, tp


def _port_tree(jp, cfg):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)


def _extra(cfg):
    """The synthetic pipeline's extra inputs of ``cfg``'s family, as the
    reference's trainer asks for them."""
    if cfg.family == "vlm":
        return {"image_embeds": ((cfg.n_image_tokens, cfg.d_model),
                                 "float32")}
    return {}


def _close_rel(got, want, label, rtol=1e-3, atol=1e-5):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    err = np.abs(got - want).max() if got.size else 0.0
    bound = atol + rtol * np.abs(want).max() if want.size else atol
    assert got.shape == want.shape, label
    assert err <= bound, f"{label}: max err {err:.3e} > {bound:.3e}"


def _counts():
    return (tk.mpgemm.launches, tk.mpgemm_grouped.launches,
            tpack.unpack_operand.launches)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "granite-moe-1b-a400m"]
                         + NEW_KINDS)
def test_train_step_matches_reference_fp32(arch):
    """One step's loss and every gradient, then loss, grad norm and
    parameters over 3 steps of AdamW, against the reference's jitted
    ``make_train_step`` on its ``xla`` backend (a VLM's batches carry
    image embeddings, its gates open: ``_pair``)."""
    jm, jp, tm, tp = _pair(arch)
    extra = _extra(tm.cfg)
    pipe_j = JSyntheticLM(jm.cfg.vocab, 4, 32, seed=3, extra_specs=extra)
    pipe_t = SyntheticLM(tm.cfg.vocab, 4, 32, seed=3, extra_specs=extra)
    batches = [pipe_j.next_batch() for _ in range(3)]
    for b in batches:
        t = pipe_t.next_batch()
        assert b.keys() == t.keys()
        assert all(np.array_equal(b[k], t[k]) for k in b)

    def jbatch(b):
        return {k: jnp.asarray(v) for k, v in b.items()}

    # One compile: the first batch's loss and gradients beside the step.
    jstep = jmake_step(jm, JAdamWConfig(lr=LR), total_steps=3, warmup=1)
    with jcfg.gemm_backend("xla"):
        jfn = jax.jit(lambda p, o, b: (jax.value_and_grad(jm.loss_fn)(p, b),
                                       jstep(p, o, b)))
        jo = jadamw_init(jp)
        steps = []
        for b in batches:
            (want_loss, want_g), (jp, jo, jmet) = jfn(jp, jo, jbatch(b))
            steps.append(jmet)
            if len(steps) == 1:
                first = want_loss, want_g
    want_loss, want_g = first
    before = _counts()
    loss, grads = _value_and_grad(
        tm, tp, device_batch(batches[0], "cpu"))
    assert _counts() == before
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_g = _port_tree(want_g, tm.cfg)
    flat_g = dict(_paths(grads))
    for path, wg in _paths(want_g):
        _close_rel(flat_g[path], wg.numpy(), f"d{path}")
    if tm.cfg.family == "vlm":        # the open gates reach the cross K/V
        for i, kind in enumerate(tm.cfg.pattern):
            if kind == "cross":
                assert all(flat_g[("layers", i, "xattn", w)].abs().max() > 0
                           for w in ("wq", "wk", "wv", "wo"))

    tstep = make_train_step(tm, AdamWConfig(lr=LR), total_steps=3, warmup=1)
    to = adamw_init(tp)
    for b, jmet in zip(batches, steps):
        tp, to, tmet = tstep(tp, to, device_batch(b, "cpu"))
        np.testing.assert_allclose(float(tmet["loss"]),
                                   float(jmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tmet["lr_scale"]),
                                   float(jmet["lr_scale"]), rtol=1e-6)
    assert int(to.step) == int(jo.step) == 3
    flat_p = dict(_paths(tp))
    for path, wp in _paths(_port_tree(jp, tm.cfg)):
        np.testing.assert_allclose(flat_p[path].detach().numpy(), wp.numpy(),
                                   atol=2e-5, rtol=0, err_msg=str(path))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,policy", [
    pytest.param("phi3-mini-3.8b", "bf16", id="bf16"),
    pytest.param("phi3-mini-3.8b", "int8", id="int8")] + [
    pytest.param(arch, policy, id=f"{arch}-{policy}")
    for arch in NEW_KINDS for policy in ("bf16", "int8")])
def test_train_step_runs_under_bf16_and_int8(arch, policy):
    """Under bf16 and int8 (STE) the step is held against the reference's
    xla step with a looser tolerance: the reference's xla backward sums in
    bf16, the port's kernels in f32, and the forward rounds every GEMM
    output to bf16.  The loss within 2 % and the grad norm within 10 %."""
    jm, jp, tm, tp = _pair(arch, policy=policy)
    batch = SyntheticLM(tm.cfg.vocab, 4, 32, seed=1,
                        extra_specs=_extra(tm.cfg)).next_batch()
    with jcfg.gemm_backend("xla"):
        _, _, jmet = jax.jit(jmake_step(jm, JAdamWConfig(lr=LR)))(
            jp, jadamw_init(jp), {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    _, _, tmet = make_train_step(tm, AdamWConfig(lr=LR))(
        tp, adamw_init(tp), device_batch(batch, "cpu"))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=2e-2)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=0.1)
    assert all(torch.isfinite(p).all() for p in tree_leaves(tp))


def test_loss_decreases():
    cfg = tcb.get("phi3-mini-3.8b", smoke=True)
    model = tbuild(cfg, policy="fp32", device="cpu", remat=False)
    tcfg = TrainerConfig(steps=90, log_every=1000, opt=AdamWConfig(lr=5e-3))
    trainer = Trainer(model, _tiny_shape(), tcfg)
    trainer.run()
    losses = [m["loss"] for m in trainer.metrics_log]
    first = sum(losses[:10]) / 10
    last = sum(losses[-10:]) / 10
    assert last < first - 0.2, (losses[:3], losses[-3:])


def test_checkpoint_resume_bit_exact(tmp_path):
    cfg = tcb.get("h2o-danube3-4b", smoke=True)
    model = tbuild(cfg, policy="fp32", device="cpu", remat=False)
    ck = str(tmp_path / "ckpt")
    tcfg = TrainerConfig(steps=8, checkpoint_every=4, checkpoint_dir=ck,
                         log_every=1000, opt=AdamWConfig(lr=1e-3))
    tr1 = Trainer(model, _tiny_shape(), tcfg)
    p1, o1 = tr1.run()

    tr2 = Trainer(model, _tiny_shape(), tcfg)
    params_like, opt_like = tr2.init_state()
    p2, o2, step = tr2.restore(params_like, opt_like, step=4)
    assert step == 4
    p2, o2 = tr2.run(p2, o2, start_step=4)
    for a, b in zip(tree_leaves(p1) + tree_leaves(o1),
                    tree_leaves(p2) + tree_leaves(o2)):
        assert torch.equal(a, b)


def test_microbatching_matches_full_batch():
    cfg = tcb.get("h2o-danube3-4b", smoke=True)
    model = tbuild(cfg, policy="fp32", device="cpu", remat=False)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (4, 33)).astype(np.int32))}
    out = []
    for mb in (1, 2):
        params = model.init_train(torch.Generator().manual_seed(0))
        opt = adamw_init(params)
        step = make_train_step(model, AdamWConfig(lr=1e-3), microbatches=mb,
                               warmup=1)
        for _ in range(2):                      # the second step moves
            params, opt, met = step(params, opt, batch)
        out.append((params, met))
    (p1, m1), (p2, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=1e-4)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-6, rtol=2e-5)


def test_eval_step_is_the_loss_without_a_graph():
    jm, jp, tm, tp = _pair("phi3-mini-3.8b")
    batch = device_batch(SyntheticLM(tm.cfg.vocab, 2, 16).next_batch(),
                         "cpu")
    loss = make_eval_step(tm)(tp, batch)
    assert not loss.requires_grad
    torch.testing.assert_close(loss, tm.loss_fn(tp, batch).detach())


# --- the optimizer -------------------------------------------------------

def test_weight_decay_follows_the_stacked_rank():
    """A layer in the reference's stack holds its (d,) norm scale as one
    (L, d) leaf, which AdamW decays (rank >= 2); the top-level final norm
    is (d,) and is not decayed, nor is a tail layer's norm scale (the
    reference keeps tail layers unstacked)."""
    mixed = dict(block_pattern=("dense", "attn_local") * 2 + ("dense",),
                 n_layers=5)
    cfg = dataclasses.replace(tcb.get("phi3-mini-3.8b", smoke=True), **mixed)
    model = tbuild(cfg, policy="fp32", device="cpu")
    params = model.init_train(torch.Generator().manual_seed(0))
    mask = decay_mask(params, cfg)
    for i in range(4):                           # two units of 2: stacked
        assert mask["layers"][i]["ln1"]["scale"] is True
        assert mask["layers"][i]["attn"]["wq"] is True
    assert mask["layers"][4]["ln1"]["scale"] is False    # the tail layer
    assert mask["layers"][4]["attn"]["wq"] is True
    assert mask["final_norm"]["scale"] is False
    assert mask["embed"] is True
    # The reference decays exactly the leaves of rank >= 2 in its tree.
    jcfg_ = dataclasses.replace(jcb.get("phi3-mini-3.8b", smoke=True),
                                **mixed)
    jp = jbuild(jcfg_, policy="fp32").init(jax.random.PRNGKey(0))
    assert jp["stack"][0]["ln1"]["scale"].ndim == 2
    assert jp["tail"][0]["ln1"]["scale"].ndim == 1
    assert jp["final_norm"]["scale"].ndim == 1


def test_adamw_moves_in_place_and_the_schedule_starts_at_zero():
    p = {"w": torch.ones(3, 2), "b": torch.ones(2)}
    opt = adamw_init(p)
    w_obj = p["w"]
    g = {"w": torch.full((3, 2), 0.5), "b": torch.full((2,), -0.5)}
    from repro_torch.optim.adamw import adamw_update
    p2, opt2, met = adamw_update(g, opt, p, AdamWConfig(lr=0.1),
                                 {"w": True, "b": False})
    assert p2["w"] is w_obj and int(opt2.step) == 1
    # Step 1: m/b1c = g, v/b2c = g², so delta = sign(g) (eps aside).
    torch.testing.assert_close(p2["b"], torch.full((2,), 1.1), atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(p2["w"], torch.full((3, 2), 1 - 0.1 * 1.1),
                               atol=1e-6, rtol=0)
    assert float(met["grad_norm"]) == pytest.approx(np.sqrt(8 * 0.25))
    s = cosine_schedule(torch.tensor(0), warmup=500, total=1000)
    assert float(s) == 0.0


def test_pick_microbatches_matches_reference():
    from repro.train.train_step import pick_microbatches as jpick
    for arch in ("phi3-mini-3.8b", "granite-moe-1b-a400m"):
        for b, s in ((4, 128), (256, 4096), (32, 32768)):
            shape = ShapeConfig("x", s, b, "train")
            jshape = jcb.ShapeConfig("x", s, b, "train")
            assert pick_microbatches(tcb.get(arch), shape, 1) == \
                jpick(jcb.get(arch), jshape, 1)


# --- pipeline, checkpointing, fault tolerance -----------------------------

def test_pipeline_equals_reference():
    extra = {"audio_embeds": ((5, 3), "float32")}
    a = SyntheticLM(1000, 4, 16, seed=9, extra_specs=extra)
    b = JSyntheticLM(1000, 4, 16, seed=9, extra_specs=extra)
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(x[k], y[k])
    snap = a.snapshot()
    a2 = SyntheticLM(1000, 4, 16, seed=0)
    a2.restore(snap)
    assert np.array_equal(a2.next_batch()["tokens"],
                          b.next_batch()["tokens"])
    t = device_batch(a.next_batch(), "cpu")
    assert t["tokens"].dtype == torch.int32


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.randn(5).to(torch.bfloat16),
                       "c": [torch.zeros(2, 2), torch.full((3,), 7)]},
            "opt": AdamWState(torch.tensor(3, dtype=torch.int32),
                              {"m": torch.ones(2)}, {"m": torch.ones(2)})}
    ck.save(10, tree, extra={"pipeline": {"seed": 1, "step": 10}})
    restored, manifest = ck.restore(tree)
    assert manifest["step"] == 10
    assert manifest["extra"]["pipeline"]["step"] == 10
    assert manifest["leaves"]["nested/b"]["dtype"] == "bfloat16"
    assert isinstance(restored["opt"], AdamWState)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_gc_keeps_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        ck.save(step, {"x": torch.ones(2) * step})
    assert ck.list_steps() == [3, 4]
    restored, m = ck.restore({"x": torch.zeros(2)})
    assert m["step"] == 4
    assert torch.equal(restored["x"], torch.tensor([4.0, 4.0]))


def test_checkpoint_async_copies_before_the_write(tmp_path):
    """The host copy is taken before save returns: an in-place update
    right after a background save does not reach the checkpoint."""
    ck = Checkpointer(str(tmp_path))
    x = torch.ones(128, 128)
    ck.save(5, {"x": x}, blocking=False)
    x.add_(1.0)
    ck.wait()
    assert ck.latest_step() == 5
    restored, _ = ck.restore({"x": torch.zeros(128, 128)})
    assert torch.equal(restored["x"], torch.ones(128, 128))


def test_straggler_detector():
    det = StragglerDetector(factor=2.0, patience=2)
    verdicts = [det.observe(t) for t in
                [1.0, 1.0, 1.0, 5.0, 5.0, 1.0, 1.0]]
    assert verdicts[3] == "suspect"
    assert verdicts[4] == "remesh"


def test_trainer_refuses_a_mesh():
    cfg = tcb.get("phi3-mini-3.8b", smoke=True)
    model = tbuild(cfg, policy="fp32", device="cpu")
    with pytest.raises(NotImplementedError):
        Trainer(model, _tiny_shape(), TrainerConfig(), mesh=object())


# --- the CLI ----------------------------------------------------------------

def test_cli_trains_on_the_cpu_in_a_subprocess():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--steps", "2", "--seq", "16"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "[train] done; final loss" in out.stdout


def test_cli_refuses_a_missing_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--smoke", "--steps", "1"])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_checkpoint_and_resume(tmp_path):
    """--ckpt saves every --ckpt-every steps; --resume restores the latest
    and runs on to --steps, bit for bit as a run that never stopped."""
    ck = str(tmp_path / "ck")
    args = ["--device", "cpu", "--smoke", "--arch", "granite-moe-1b-a400m",
            "--seq", "16", "--batch", "2", "--policy", "fp32"]
    _, p_full, o_full = ttrain.main(args + ["--steps", "3"])
    tr, _, _ = ttrain.main(args + ["--steps", "2", "--ckpt", ck,
                                   "--ckpt-every", "2"])
    assert Checkpointer(ck).list_steps() == [2]
    tr, p_res, o_res = ttrain.main(args + ["--steps", "3", "--ckpt", ck,
                                           "--resume"])
    assert [r["step"] for r in tr.metrics_log] == [2]
    for a, b in zip(tree_leaves(p_full) + tree_leaves(o_full),
                    tree_leaves(p_res) + tree_leaves(o_res)):
        assert torch.equal(a, b)


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "granite-moe-1b-a400m"]
                         + NEW_KINDS)
def test_chip_smoke_train_launch_counts_match_the_dispatch(arch,
                                                           monkeypatch):
    """The per-step launch counts ``chip_smoke.py`` asserts on the card
    (``_want_train_launches``) equal the wrapper calls of one CPU train
    step with remat: every wrapper call is one kernel launch on the
    card."""
    from repro_torch.core import gemm as gemm_mod
    from repro_torch.models import attention as attn_mod
    counts = dict.fromkeys(["k1", "k1_ta", "k1_tb", "k1g", "k1g_ta",
                            "k1g_tb", "k4", "k7"], 0)

    def gemm(name, inner):
        def call(a, b, *, spec, **kw):
            counts[name] += 1
            counts[name + "_ta"] += int(spec.trans_a)
            counts[name + "_tb"] += int(spec.trans_b)
            return inner(a, b, spec=spec, **kw)
        return call

    def once(name, inner):
        def call(*args, **kw):
            counts[name] += 1
            return inner(*args, **kw)
        return call

    monkeypatch.setattr(gemm_mod, "mpgemm", gemm("k1", gemm_mod.mpgemm))
    monkeypatch.setattr(gemm_mod, "mpgemm_grouped",
                        gemm("k1g", gemm_mod.mpgemm_grouped))
    monkeypatch.setattr(gemm_mod, "unpack_operand",
                        once("k7", gemm_mod.unpack_operand))
    monkeypatch.setattr(attn_mod, "flash_attention",
                        once("k4", attn_mod.flash_attention))
    _, _, tm, tp = _pair(arch, policy="bf16")
    batch = device_batch(SyntheticLM(tm.cfg.vocab, 2, 16,
                                     extra_specs=_extra(tm.cfg)).next_batch(),
                         "cpu")
    make_train_step(tm, AdamWConfig())(tp, adamw_init(tp), batch)
    want = _chip_smoke()._want_train_launches(tm.cfg, seq=16)
    assert counts == {k: want[k] for k in counts}
