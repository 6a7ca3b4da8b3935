"""Serving launcher of the PyTorch port: batched prefill + greedy decode
with the model's cache (the counterpart of ``examples/serve_decode.py``,
plus ``--device`` and ``--reduced``).

    PYTHONPATH=src python -m repro_torch.launch.serve_decode \
        --arch mamba2_370m                          # full width, cuda
    PYTHONPATH=src python -m repro_torch.launch.serve_decode \
        --arch mamba2_370m --reduced --device cpu

Weights are random, from seed 0; the prompt holds the token ids the
example's ``make_batch`` draws. Runs on the CUDA card unless
``--device cpu`` is given; asking for cuda without a card raises. Only
the ssm family has a decode path in the port (others raise
NotImplementedError, ROADMAP.md queue A item 6).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.data.pipeline import prng_key, randint, split
from repro_torch.models.registry import build_model
from repro_torch.train.steps import make_decode_step
from repro_torch.train.trainer import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_370m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises when CUDA is "
                         "unavailable — pass cpu explicitly)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    device = resolve_device(args.device)
    model = build_model(cfg)
    params = model.init(0, device)
    cache = model.init_cache(args.batch, args.prompt_len + args.new_tokens,
                             device)
    k1, _ = split(prng_key(0))
    tokens = torch.from_numpy(randint(k1, (args.batch, args.prompt_len), 0,
                                      cfg.vocab_size)).to(device)
    decode = make_decode_step(model)
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": tokens}, cache)
        tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        out = [tok]
        for i in range(args.new_tokens - 1):
            tok, cache = decode(params, tok, cache, args.prompt_len + i)
            out.append(tok)
    seq = torch.cat(out, dim=1)
    print(f"arch={cfg.name} batch={args.batch}")
    print("generated token ids:")
    print(seq.cpu().numpy())
    return seq


if __name__ == "__main__":
    main()
