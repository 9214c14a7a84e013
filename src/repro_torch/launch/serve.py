"""Serving entrypoint: generation with the port's ServeEngine, on the card
by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
        --pack --pack-format int4 [--policy int8]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-1b-a400m [--pack --pack-format int4]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-medium --engine wave
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch rwkv6-1.6b --engine wave
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
        --sparsity 0.5
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-1b-a400m --policy int8 --sparsity 0.5 \
        --sparsity-method nm
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --no-fuse

``--arch`` takes every architecture of ``configs/base.py::ARCH_IDS``.  The
default ``--engine continuous`` runs the paged-KV continuous-batching
engine; ``--engine wave`` the static-batch wave engine, the only one that
serves whisper-medium, llama-3.2-vision-11b, rwkv6-1.6b and
recurrentgemma-2b (their enc-dec, cross-attention and recurrent blocks
have no paged step: the continuous engine raises for them).  On the card
both engines run their steps in CUDA graphs (the wave engine its decode
step; prefill stays eager), and the ``[serve] CUDA graphs:`` line counts
them.

Weights are random (drawn from a seeded ``torch.Generator`` on the target
device).  ``--pack`` packs them from their f32 draw; under bf16 a packed
bf16 payload is a change of layout only, so it gives the same tokens as no
``--pack``.  Without a card, leave ``--device cuda`` (the default) and the
command exits non-zero; ``--device cpu`` runs the plain PyTorch path.
"""
import argparse
import sys
import time
import warnings

import numpy as np
import torch

from repro_torch.configs import base as cb
from repro_torch.models.transformer import build_model, resolve_device
from repro_torch.packing.params import packed_param_bytes
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.sparse.params import (
    nm_for_sparsity, sparse_param_bytes, sparse_param_density,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=cb.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced SMOKE config")
    ap.add_argument("--policy", default="bf16",
                    choices=["bf16", "bf16_serve", "int8"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "wave"],
                    help="continuous: paged-KV continuous batching; wave: "
                         "the static-batch wave engine (the only path of "
                         "whisper, llama-vision, rwkv6, recurrentgemma)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="concurrent sequence slots (default 2); the wave "
                         "width under --engine wave")
    ap.add_argument("--batch", type=int, default=None,
                    help="DEPRECATED alias for --max-batch")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in tokens")
    ap.add_argument("--max-pages", type=int, default=None,
                    help="KV pool size in pages incl. the scratch page "
                         "(default: dense-equivalent capacity; smaller "
                         "values exercise preemption)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens prefilled per step (default "
                         "max(page_size, 8))")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--warm-prefix", type=int, default=0, metavar="N",
                    help="pre-populate the prefix index with an N-token "
                         "synthetic system prompt that every request then "
                         "prepends")
    ap.add_argument("--pack", action="store_true",
                    help="pack the GEMM weights into 128 x 128 tiles at load "
                         "time (repro_torch.packing); the packed GEMM kernel "
                         "reads them")
    ap.add_argument("--pack-format", default=None,
                    choices=["int8", "int4", "fp8"],
                    help="payload codec for --pack: int8 per-tile quantized, "
                         "int4 nibble-packed (half the int8 bytes), fp8 e4m3 "
                         "scaled.  Default: the policy's payload dtype")
    ap.add_argument("--sparsity", type=float, default=0.0,
                    help="fraction of weight TILES to prune at load time "
                         "(repro_torch.sparse tile-magnitude pruning; 0 = "
                         "off); the tile-sparse GEMM then skips the pruned "
                         "tiles")
    ap.add_argument("--sparsity-method", default="magnitude",
                    choices=["magnitude", "nm"],
                    help="tile sparsifier: magnitude top-k per operand, or "
                         "structured N:M over k-tiles (N of every 4 kept, N "
                         "derived from --sparsity -- the level rounds to a "
                         "multiple of 1/4)")
    ap.add_argument("--sparsity-blocks", type=int, nargs=2, default=None,
                    metavar=("BK", "BN"),
                    help="tile size of the sparsity lattice (default 128 x "
                         "128, clamped to each weight)")
    ap.add_argument("--no-fuse", action="store_true",
                    help="run the MLPs unfused: the gated activation and "
                         "the residual add as separate ops after their "
                         "GEMMs, for A/B runs against the fused epilogues "
                         "(the default)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default: the card; cpu runs the "
                         "plain PyTorch path)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.pack_format is not None and not args.pack:
        raise SystemExit("--pack-format requires --pack")
    if not 0.0 <= args.sparsity < 1.0:
        raise SystemExit(f"--sparsity must be in [0, 1) -- a fraction of "
                         f"tiles to prune, got {args.sparsity}")
    if args.pack and args.sparsity > 0:
        raise SystemExit("--pack and --sparsity are mutually exclusive "
                         "(a weight is stored packed-dense OR tile-sparse)")
    if args.warm_prefix and args.engine == "wave":
        raise SystemExit("--warm-prefix requires --engine continuous "
                         "(prefix sharing lives in the paged KV cache)")
    if args.batch is not None:
        print("[serve] --batch is deprecated; use --max-batch "
              "(and --engine wave for the wave engine)")
        if args.max_batch is None:
            args.max_batch = args.batch
    max_batch = args.max_batch if args.max_batch is not None else 2

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"[serve] {e}", file=sys.stderr)
        return 2
    if args.warm_prefix and args.warm_prefix + 32 + args.max_new >= \
            args.max_len:
        raise SystemExit(f"--warm-prefix {args.warm_prefix} leaves no room "
                         f"for request tails under --max-len {args.max_len}")

    cfg = cb.get(args.arch, smoke=args.smoke)
    model = build_model(cfg, policy=args.policy, device=device,
                        fused_epilogues=not args.no_fuse)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.sparsity > 0 and args.sparsity_method == "nm":
        n_keep, m_block = nm_for_sparsity(args.sparsity)
        print(f"[serve] N:M sparsity: keeping {n_keep} of every {m_block} "
              f"k-tiles (requested prune {args.sparsity:.2f} -> effective "
              f"{1 - n_keep / m_block:.2f})")
    params = model.init(gen, pack=args.pack, pack_format=args.pack_format,
                        sparsity=args.sparsity,
                        sparsity_method=args.sparsity_method,
                        sparsity_blocks=args.sparsity_blocks)
    if args.pack:
        fmt = f", format={args.pack_format}" if args.pack_format else ""
        print(f"[serve] packed static weights: "
              f"{packed_param_bytes(params) / 2**20:.1f} MiB payload{fmt}")
    if args.sparsity > 0:
        density = sparse_param_density(params, model.cfg)
        print(f"[serve] tile-sparse static weights: "
              f"{sparse_param_bytes(params) / 2**20:.1f} MiB payload, "
              f"tile density {density:.2f} ({args.sparsity_method})")
        if density > (1.0 - args.sparsity) + 0.1:
            print(f"[serve] WARNING: effective tile density {density:.2f} "
                  f"is well above the requested {1 - args.sparsity:.2f} -- "
                  f"the tile lattice is too coarse for these weight shapes "
                  f"(pruning is per whole tile). Pass --sparsity-blocks "
                  f"with smaller BK BN for finer granularity.")
    if args.engine == "wave":
        with warnings.catch_warnings():
            # The CLI chose the wave engine explicitly; the constructor's
            # deprecation warning targets programmatic batch_size= callers.
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = ServeEngine(model, params, batch_size=max_batch,
                              max_len=args.max_len)
    else:
        eng = ServeEngine(model, params, max_len=args.max_len,
                          max_batch=max_batch, page_size=args.page_size,
                          max_pages=args.max_pages,
                          prefill_chunk=args.prefill_chunk)
    rng = np.random.default_rng(args.seed)
    warm = None
    if args.warm_prefix > 0:
        warm = rng.integers(2, cfg.vocab, (args.warm_prefix,)).astype(
            np.int32)
        t_w = time.perf_counter()
        new_pages = eng.warm_prefixes([warm])
        print(f"[serve] warmed {new_pages} prefix pages from a "
              f"{args.warm_prefix}-token system prompt in "
              f"{time.perf_counter() - t_w:.2f}s")

    def _prompt():
        tail = rng.integers(2, cfg.vocab,
                            (int(rng.integers(4, 32)),)).astype(np.int32)
        return tail if warm is None else np.concatenate([warm, tail])

    reqs = [Request(uid=i, prompt=_prompt(), max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in out.values())
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[serve] {cfg.name} on {where}: {args.requests} requests, "
          f"{n_tok} tokens, {dt:.3f}s ({n_tok / dt:.1f} tok/s, "
          f"policy={args.policy}, engine={args.engine})")
    steps = eng.step_telemetry
    if args.engine == "wave":
        for t in eng.telemetry:
            print(f"  wave{t.wave}: {t.requests} reqs, {t.tokens} tok, "
                  f"{t.decode_steps} decode steps, {t.tokens_per_s:.1f} "
                  f"tok/s, prefill {t.prefill_s:.3f}s, occupancy "
                  f"{t.slot_occupancy:.2f}, queue {t.queue_depth}")
    else:
        peak_pages = max((s.pages_in_use for s in steps), default=0)
        preempt = sum(s.preemptions for s in steps)
        shared = steps[-1].prefix_hit_tokens if steps else 0
        print(f"  {len(steps)} steps "
              f"({sum(1 for s in steps if s.phase != 'decode')} with "
              f"prefill), peak {peak_pages} pages, {preempt} preemptions, "
              f"{shared} prompt tokens prefix-shared")
    graphs = eng.graphs
    if graphs:
        print(f"[serve] CUDA graphs: {len(graphs)} captured, "
              f"{sum(g.replays for g in graphs.values())} replays, "
              f"{sum(g.capture_s for g in graphs.values()):.3f} s "
              f"capturing, pool {eng.graph_pool_bytes() / 2**20:.2f} MB")
    else:
        why = ("a CPU model runs the eager step" if graphs is None
               else "no decode step ran")
        print(f"[serve] CUDA graphs: none captured ({why})")
    for uid in sorted(out):
        print(f"  req{uid}: {out[uid][:10]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
