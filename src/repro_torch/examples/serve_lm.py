"""Batched serving with the slot-wave engine, on the port: initializes an
LM's smoke config, serves a batch of prompt requests and reports each
request's tokens and the throughput.  The twin of the JAX package's
`examples/serve_lm.py`: the same params (`LM.init(PRNGKey(0))`) and the
same prompts (keys split off PRNGKey(1), request i of 3 + i % 5 tokens
from `randint`).

  python -m repro_torch.examples.serve_lm --arch rwkv6-3b --requests 6
  python -m repro_torch.examples.serve_lm --device cpu
"""
from __future__ import annotations

import argparse
import time

from repro_torch import prng
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.models.transformer import LM
from repro_torch.runtime import resolve_device
from repro_torch.serve import ServeEngine


def prompts_for(n_requests: int, vocab_size: int, device) -> list:
    """The JAX script's prompts: request i has 3 + i % 5 tokens, drawn by
    `randint(k, (n,), 0, vocab)` under a key split off PRNGKey(1)."""
    rng = prng.PRNGKey(1, device=device)
    prompts = []
    for i in range(n_requests):
        rng, k = prng.split(rng)
        n = 3 + i % 5
        prompts.append([int(t) for t in
                        prng.randint(k, (n,), 0, vocab_size).cpu()])
    return prompts


def main(argv=None) -> list:
    """Serve and print the JAX script's lines; return the results."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi3-medium-14b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, "smoke")
    lm = LM(cfg)
    params = lm.init(prng.PRNGKey(0, device=dev), device=dev)
    engine = ServeEngine(lm, params, batch_slots=args.slots, max_len=128,
                         temperature=args.temperature)
    prompts = prompts_for(args.requests, cfg.vocab_size, dev)

    t0 = time.time()
    results = engine.generate(prompts, max_new_tokens=args.max_new)
    dt = time.time() - t0
    total_new = sum(len(r.tokens) for r in results)
    for i, r in enumerate(results):
        print(f"req {i}: prompt={r.prompt} -> {r.tokens}")
    print(f"\n{len(results)} requests, {total_new} tokens in {dt:.1f}s "
          f"({total_new/dt:.1f} tok/s, {args.slots} slots, "
          f"arch={args.arch} smoke)")
    return results


if __name__ == "__main__":
    main()
