"""Serving example on the PyTorch port (twin of ``examples/serve_f2p_kv.py``):
batched generation with an F2P8-quantized KV cache.

Builds a small LM from a seed, then serves a batch of prompts twice —
exact f32 cache vs F2P8 cache — and reports memory saved + output
agreement. On the card the F2P8 run writes its KV through B3
(``quantize_packed_write_kernel``) and, with ``ServeConfig``'s default
``fused_attention=False``, reads each layer's K and V back through B4
(``dequantize_packed_kernel``) at every decode step.

    PYTHONPATH=src python examples/torch_serve_f2p_kv.py [--device cpu]

Differences from the reference, by design: the port's quantized caches are
always bit-packed, and at 8 bits a packed cache costs exactly the
reference's unpacked bytes (4 codes per uint32 word), so the MB line reads
the same; the weights and prompts come from ``torch.Generator`` seeds (7
and 1), so the tokens are the twin's own — :func:`serve_demo` takes a
``model`` and ``prompts`` to serve the reference's instead.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.fl import _tree
from repro_torch.models import init_caches, init_params
from repro_torch.models.config import ModelConfig, dense_pattern
from repro_torch.serve import Engine, ServeConfig


def demo_config() -> ModelConfig:
    return ModelConfig(name="serve-demo", n_layers=4, d_model=256, n_heads=8,
                       n_kv_heads=4, d_ff=512, vocab_size=1024,
                       pattern=dense_pattern(), dtype="float32", remat=False)


def serve_demo(device, *, model=None, prompts=None) -> dict:
    """Serve ``prompts`` (default: seeded [4, 32]) with the exact and the
    F2P8 cache; returns ``{"tokens": {False, True}, "cache_mb": {...},
    "agreement": float}`` and prints the reference's report."""
    cfg = demo_config()
    if model is None:
        model = init_params(cfg, seed=7, device=device)
    B, S, new = 4, 32, 16
    if prompts is None:
        g = torch.Generator().manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
        prompts = prompts.numpy().astype(np.int32)

    outs, mb = {}, {}
    for quant in (False, True):
        scfg = ServeConfig(batch=B, max_seq=S + new, quantized_kv=quant)
        eng = Engine(cfg, scfg, model)
        outs[quant] = eng.generate(prompts, max_new=new)
        cache = init_caches(cfg, B, S + new, quantized_kv=quant,
                            device=device)
        mb[quant] = sum(x.numel() * x.element_size()
                        for x in _tree.leaves(cache, expand_q=True)) / 1e6
        print(f"quantized_kv={quant}: cache={mb[quant]:.2f} MB, "
              f"first row: {outs[quant][0][:8].tolist()}")

    agree = float((outs[True] == outs[False]).mean())
    print(f"token agreement exact-vs-F2P8: {agree:.2%}")
    return {"tokens": outs, "cache_mb": mb, "agreement": agree}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    serve_demo(require_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
