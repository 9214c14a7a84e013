"""Training entrypoint, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-1b-a400m --steps 3 --ckpt /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 2 \
        --device cpu

Every architecture trains, the cross and recurrent kinds too
(llama-3.2-vision-11b, rwkv6-1.6b, recurrentgemma-2b).  Weights are random
f32 masters drawn from ``--seed`` on the device; the batches come from the
seeded synthetic pipeline (a VLM's with random ``image_embeds``, an audio
model's with ``audio_embeds``, as the reference's).  ``--layers N`` keeps
the first N layers of the architecture's pattern: llama-3.2-vision-11b at
5 is four dense layers and a cross one, recurrentgemma-2b at 5 is
``rglru, rglru, attn_local, rglru, rglru``.  ``--ckpt DIR`` saves
every ``--ckpt-every`` steps (in the background); ``--resume`` restores
the latest checkpoint there and runs on to ``--steps``.  Without a card,
leave ``--device cuda`` (the default) and the command exits non-zero;
``--device cpu`` runs the plain PyTorch path.  On the card the step runs
in a CUDA graph after its first eager step (``Trainer``); the ``CUDA
graphs:`` line says how many were captured and replayed, the seconds the
capture took and the MB its memory pool holds.
"""
import argparse
import dataclasses
import sys

from repro_torch.configs import base as cb
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.transformer import build_model, resolve_device
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.train.trainer import Trainer, TrainerConfig


def cut_layers(cfg, n_layers: int):
    """``cfg`` cut to the first ``n_layers`` layers of its pattern: an
    explicit ``block_pattern`` is sliced, a derived one (a VLM's cross
    layer every ``cross_attn_every``, rwkv's, MoE's) is derived again."""
    return dataclasses.replace(cfg, n_layers=n_layers,
                               block_pattern=cfg.block_pattern[:n_layers])


def main(argv=None):
    """Run the CLI; -> (trainer, params, opt_state) after the last step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube3-4b", choices=cb.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced SMOKE config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--policy", default="bf16",
                    choices=["fp32", "bf16", "int8"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint every N steps (with --ckpt)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the architecture to its first N layers")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"[train] {e}", file=sys.stderr)
        raise SystemExit(2)

    cfg = cb.get(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = cut_layers(cfg, args.layers)
    model = build_model(cfg, policy=args.policy, device=device)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tcfg = TrainerConfig(steps=args.steps, microbatches=args.microbatches,
                         checkpoint_every=args.ckpt_every,
                         checkpoint_dir=args.ckpt,
                         opt=AdamWConfig(lr=args.lr))
    trainer = Trainer(model, shape, tcfg, seed=args.seed)
    params, opt = trainer.init_state()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}: {len(cfg.pattern)} layers, "
          f"{n_params / 1e6:.1f}M params, policy={args.policy}, "
          f"device={device}")
    start = 0
    if args.resume and args.ckpt:
        params, opt, start = trainer.restore(params, opt)
        print(f"[train] resumed from step {start}")
    params, opt = trainer.run(params, opt, start_step=start)
    graph = trainer.graph
    if graph is not None:
        print(f"[train] CUDA graphs: 1 captured, {graph.replays} replays, "
              f"{graph.capture_s:.3f} s capturing, pool "
              f"{trainer.graph_pool_bytes() / 2**20:.2f} MB")
    else:
        why = ("fewer than two steps to run" if trainer.cuda_graphs
               else "off, the eager loop")
        print(f"[train] CUDA graphs: none captured ({why})")
    print("[train] done; final loss",
          trainer.metrics_log[-1]["loss"] if trainer.metrics_log else "n/a")
    return trainer, params, opt


if __name__ == "__main__":
    main()
