"""Serve a small model with batched requests: stream a prompt batch
through the decode steps (filling the KV cache), then generate tokens one
step at a time, the counterpart of ``examples/serve_demo.py``.  The step
is ``launch.serve.make_serve_step``, the decode_32k shape's step.

    PYTHONPATH=src python -m repro_torch.serve_demo --arch yi_34b --tokens 32
    PYTHONPATH=src python -m repro_torch.serve_demo --device cpu
"""
import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import decode_batch, make_serve_step
from repro_torch.models import init_cache, init_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron_8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    dev = resolve_device(args.device)
    params = init_params(0, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    B, P = args.batch, args.prompt_len
    total = P + args.tokens
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen,
                           dtype=torch.int32, device=dev)
    serve_step = make_serve_step(cfg)
    cache = init_cache(cfg, B, total, device=dev)

    # prefill by streaming the prompt through decode (cache-building) steps
    t0 = time.time()
    for t in range(P):
        nxt, logits, cache = serve_step(params,
                                        decode_batch(cfg, prompt[:, t:t + 1]),
                                        cache, t)
    generated = []
    tok = nxt[:, None]
    for t in range(P, total):
        nxt, logits, cache = serve_step(params, decode_batch(cfg, tok), cache,
                                        t)
        tok = nxt[:, None]
        generated.append(nxt)
    gen_tokens = torch.stack(generated, dim=1).cpu()
    wall = time.time() - t0
    print(f"arch={cfg.name} batch={B} generated {gen_tokens.shape[1]} "
          f"tokens/seq in {wall:.2f}s ({wall / total * 1e3:.1f} ms/token, "
          f"device={dev})")
    print("first sequence:", gen_tokens[0][:16].tolist())
    if not bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab)).all()):
        raise SystemExit("generated tokens outside the vocabulary")
    print("OK")


if __name__ == "__main__":
    main()
