"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [options]``.

Runs real steps of an LM arch: random weights from ``--seed``, synthetic
token batches (``SyntheticTokens``, batch ``i`` a function of the seed and
``i``) through a prefetching thread, the train step in f32 with a 10-step
warmup, asynchronous checkpoints of (parameters, AdamW state) every
``--ckpt-every`` steps and at the end, and ``--resume`` from the latest
one.  ``--smoke`` takes the arch's small config; ``--device`` defaults to
the card and raises without one.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from pathlib import Path

import torch

from ..checkpoint import manager as ckpt
from ..configs import registry
from ..data.pipeline import Prefetcher, SyntheticTokens
from ..models import transformer as T
from ..optim import adamw
from ..train.step import make_lm_train_step


def main(argv=None) -> dict:
    """Run the loop; returns what it made (config, parameters, optimizer
    state, the first step, each step's loss, the checkpoint directory) for
    callers that check it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=registry.arch_ids())
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and batches")
    args = ap.parse_args(argv)

    if registry.FAMILY[args.arch] != "lm":
        raise SystemExit("this launcher trains LM archs; see launch/train_gnn.py for GNNs")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the host")
    cfg = registry.get_smoke_config(args.arch) if args.smoke else registry.get_config(args.arch)
    print(f"[train] arch={cfg.name} params={cfg.n_params/1e6:.1f}M "
          f"active={cfg.n_active_params/1e6:.1f}M ({device})")

    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed),
                           device=device)
    opt_state = adamw.init(params)
    start = 0
    ckpt_dir = Path(args.ckpt_dir) / cfg.name
    if args.resume and ckpt.latest_step(ckpt_dir) is not None:
        (params, opt_state), meta = ckpt.restore(ckpt_dir, (params, opt_state))
        start = meta["step"] + 1
        print(f"[train] resumed from step {meta['step']}")

    step_fn = make_lm_train_step(cfg, compute_dtype=torch.float32, warmup=10,
                                 total=max(args.steps, 20))
    data = Prefetcher(SyntheticTokens(cfg.vocab, args.batch, args.seq, seed=args.seed),
                      start=start)
    saver = ckpt.AsyncCheckpointer(ckpt_dir)
    losses = []
    t0 = time.time()
    try:
        for step in range(start, args.steps):
            batch = next(data)
            tokens, targets = (torch.from_numpy(batch[k]).to(device)
                               for k in ("tokens", "targets"))
            params, opt_state, metrics = step_fn(params, opt_state, tokens, targets)
            losses.append(float(metrics["loss"]))
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step} loss {losses[-1]:.4f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
            if args.ckpt_every and step and step % args.ckpt_every == 0:
                saver.save(step, (params, opt_state), extra={"arch": cfg.name})
        saver.save(args.steps - 1, (params, opt_state), extra={"arch": cfg.name})
        saver.wait()
    finally:
        data.close()
    final = f"final loss {losses[-1]:.4f}" if losses else "no step to take"
    print(f"[train] done: {args.steps - start} steps, {final}")
    return {"cfg": cfg, "params": params, "opt": opt_state, "start": start,
            "losses": losses, "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
