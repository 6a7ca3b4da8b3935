"""The straggler factor of the dropless MoE layer's grouped product: for
each MoE layer, its heaviest held expert's (token, k) pairs over its held
experts' mean, each summed over the run; the mean of that ratio over the
layers. Read from the program's device counter, (MoE layers, held
experts) (``moe_apply_dropless.pairs`` of ``repro_torch.models.layers``),
after the run; None where the program has no such counter or counted
nothing. A layer that counted nothing is left out of the mean."""
import sys


def read(rec):
    layers = sys.modules.get("repro_torch.models.layers")
    fn = getattr(layers, "moe_apply_dropless", None)
    pairs = getattr(fn, "pairs", None)
    if pairs is None:
        return None
    c = pairs.detach().double().cpu().reshape(-1, pairs.shape[-1])
    c = c[c.sum(1) > 0]
    if not len(c):
        return None
    return float((c.max(1).values / c.mean(1)).mean())
