"""Serving launcher of the PyTorch port: batched prefill + greedy decode
with the model's cache (the counterpart of ``examples/serve_decode.py``,
plus ``--device`` and ``--reduced``).

    PYTHONPATH=src python -m repro_torch.launch.serve_decode \
        --arch mamba2_370m                          # full width, cuda
    PYTHONPATH=src python -m repro_torch.launch.serve_decode \
        --arch mamba2_370m --reduced --device cpu

Weights are random, from seed 0; the prompt is the example's
``make_batch`` less its labels: its token ids, and the constant patch
embeddings (vlm) or audio frames (encdec) of the stubbed frontends. A
vision prefix takes its place in the cache before the prompt, so the
cache and the decode positions count it. Runs on the CUDA card unless
``--device cpu`` is given; asking for cuda without a card raises. Serves
every family: dense (GQA, gemma2's ring cache, MLA's latent cache), moe,
vlm, ssm, hybrid and encdec; ``--arch`` also takes the paper's own
models (``gpt3_0_7b`` … ``gpt3_13b``, ``gpt3_1_8b_moe``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import (PAPER_ARCH_IDS, get_config,
                                 get_paper_config, reduced as make_reduced)
from repro_torch.models.registry import build_model, make_batch
from repro_torch.train.steps import make_decode_step
from repro_torch.train.trainer import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_370m",
                    help="a config key: any of ARCH_IDS or a paper key "
                         "(gpt3_*)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises when CUDA is "
                         "unavailable — pass cpu explicitly)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    args = ap.parse_args(argv)

    cfg = (get_paper_config(args.arch) if args.arch in PAPER_ARCH_IDS
           else get_config(args.arch))
    if args.reduced:
        cfg = make_reduced(cfg)
    device = resolve_device(args.device)
    model = build_model(cfg)
    params = model.init(0, device)
    n_prefix = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    cache = model.init_cache(
        args.batch, args.prompt_len + args.new_tokens + n_prefix, device)
    batch = make_batch(cfg, args.batch, args.prompt_len, device=device)
    batch.pop("labels")
    decode = make_decode_step(model)
    pos = args.prompt_len + n_prefix
    with torch.inference_mode():
        logits, cache = model.prefill(params, batch, cache)
        tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        out = [tok]
        for i in range(args.new_tokens - 1):
            tok, cache = decode(params, tok, cache, pos + i)
            out.append(tok)
    seq = torch.cat(out, dim=1)
    print(f"arch={cfg.name} batch={args.batch}")
    print("generated token ids:")
    print(seq.cpu().numpy())
    return seq


if __name__ == "__main__":
    main()
