"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Batched greedy decode with a KV cache: random weights from ``--seed``, a
synthetic prompt batch fed token by token, then ``--decode-tokens`` tokens
per request, reporting tokens/s.  Decode attention takes its route per
layer (``serve.decode.serve_attn_fn``): the ``flash_decode`` kernel for a
global layer, the plain masked attention for a sliding-window layer whose
window is below the cache length (Gemma-2's local layers); the weights
and the cache are f32, as in the reference.  ``--smoke`` takes the
arch's small config; ``--device`` defaults to the card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import registry
from ..kernels.runtime import drain
from ..models import transformer as T
from ..serve.decode import make_decode_step, serve_attn_fn


def _sync(device: torch.device) -> None:
    """Drain every visible card (not only ``device``): the timed loop ends
    when all queued work has."""
    if device.type == "cuda":
        drain()


def main(argv=None) -> dict:
    """Run the loop; returns what it made (config, parameters, cache, the
    prompt, the logits after its last token, the generated tokens [B, 1 +
    decode_tokens], the last logits, the next free position and tokens/s)
    for callers that check it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=registry.arch_ids())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and prompt")
    args = ap.parse_args(argv)

    if registry.FAMILY[args.arch] != "lm":
        raise SystemExit("this launcher serves LM archs")
    if args.prompt_len < 1 or args.prompt_len + args.decode_tokens > args.max_seq:
        raise SystemExit("need 1 <= prompt-len and prompt-len + decode-tokens <= max-seq")
    cfg = registry.get_smoke_config(args.arch) if args.smoke else registry.get_config(args.arch)
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    dtype = torch.float32
    params = T.init_params(cfg, gen, dtype=dtype, device=device)
    step = make_decode_step(cfg, compute_dtype=dtype, attn_fn=serve_attn_fn)

    b = args.batch
    cache = T.init_cache(cfg, b, args.max_seq, dtype=dtype, device=device)
    prompt = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, size=(b, args.prompt_len), dtype=np.int32)).to(device)
    for t in range(args.prompt_len):  # token by token, as the reference
        logits, next_tok, cache = step(params, cache, prompt[:, t:t + 1], t)
    prompt_logits = logits
    out = [next_tok[:, None]]
    _sync(device)
    t0 = time.perf_counter()
    for i in range(args.decode_tokens):
        logits, next_tok, cache = step(params, cache, out[-1], args.prompt_len + i)
        out.append(next_tok[:, None])
    _sync(device)
    dt = time.perf_counter() - t0
    tokens = torch.cat(out, 1)
    total = b * args.decode_tokens
    print(f"[serve] {cfg.name}: {total} tokens in {dt:.2f}s = {total / dt:.1f} tok/s "
          f"(batch {b}, {device})")
    print("[serve] sample ids:", tokens[0, :16].cpu().numpy())
    return {"cfg": cfg, "params": params, "cache": cache, "prompt": prompt,
            "prompt_logits": prompt_logits, "tokens": tokens, "logits": logits,
            "pos": args.prompt_len + args.decode_tokens, "tok_per_s": total / dt, "seconds": dt}


if __name__ == "__main__":
    main()
