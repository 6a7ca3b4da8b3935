"""Stand-ins for every model input on ``device="meta"`` (the counterpart
of ``repro.launch.inputs``, whose ``ShapeDtypeStruct``s they replace):
shapes and dtypes only, nothing allocated. The dry run
(``launch/dryrun.py``) runs its steps on these."""
from __future__ import annotations

import torch

from repro_torch.train.steps import init_train_state
from repro_torch.tree import tree_map

META = torch.device("meta")


def batch_structs(cfg, batch: int, seq: int) -> dict:
    """tokens and labels (int32), the vision frontend's bf16 patch
    embeddings, encdec's bf16 audio frames."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)
    b = {"tokens": empty((batch, seq), torch.int32),
         "labels": empty((batch, seq), torch.int32)}
    if cfg.frontend == "vision":
        b["patch_embeds"] = empty((batch, cfg.n_frontend_tokens,
                                   cfg.d_model), torch.bfloat16)
    if cfg.arch_type == "encdec":
        b["audio_frames"] = empty((batch, cfg.n_enc_ctx, cfg.d_model),
                                  torch.bfloat16)
    return b


def input_specs(cfg, shape, model) -> dict:
    """The step's inputs for ``shape`` (an ``INPUT_SHAPES`` entry), as
    the reference's: train → {"state": the TrainState (bf16 params; Adam
    step, f32 master, m, v), "batch"}; prefill → {"params" (bf16),
    "batch" (no labels), "cache"}; decode (ONE new token against a
    seq-length cache) → {"params", "tokens" (B, 1), "cache", "pos" (an
    int32 scalar)}. A vision prefix adds its patch tokens to the cache's
    length."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"state": init_train_state(model, 0, META),
                "batch": batch_structs(cfg, B, S)}
    params = tree_map(lambda p: p.to(torch.bfloat16)
                      if p.dtype == torch.float32 else p,
                      model.init(0, META))
    n_prefix = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    cache = model.init_cache(B, S + n_prefix, META)
    if shape.kind == "prefill":
        batch = batch_structs(cfg, B, S)
        batch.pop("labels")
        return {"params": params, "batch": batch, "cache": cache}
    return {"params": params,
            "tokens": torch.empty((B, 1), dtype=torch.int32, device=META),
            "cache": cache,
            "pos": torch.empty((), dtype=torch.int32, device=META)}
