"""Serving entry point: one batch of requests through prefill and decode.

Counterpart of `repro.launch.serve`: seeded random weights and prompts,
then `serve_step.generate`. It runs on the CUDA card unless the caller
passes device="cpu", refuses encoder-only archs (no decode step), and
prints the prefill's and the decode steps' tokens/s (the device
synchronised after each part) beside the JAX CLI's combined figure. A
vision arch gets seeded random patch features before its prompt.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --batch 8 --prompt-len 512 --gen 128
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --reduced --batch 4 --prompt-len 32 --gen 32 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.fabsp import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.train import serve_step as ss_lib


def serve(arch: str, *, reduced: bool, batch: int, prompt_len: int,
          gen: int, temperature: float = 0.0, device=None,
          **cfg_overrides) -> dict:
    """Generate `gen` tokens for `batch` random prompts of `prompt_len`
    tokens (weights and prompts from seed 0, a bf16 cache). Returns the
    tokens (B, gen), the prefill's seconds, each decode step's seconds,
    the whole call's wall seconds (host clock, device synchronised), the
    three tokens/s figures and, on the card, the peak device memory."""
    dev = resolve_device(device)
    cfg = (reduced_config(arch, **cfg_overrides) if reduced
           else dataclasses.replace(get_config(arch), **cfg_overrides))
    if not cfg.causal:
        raise ValueError(f"{arch} is encoder-only: no decode step")
    params = model_lib.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len))).to(dev)
    extra, n_patch = None, 0
    if cfg.frontend.kind == "vision":
        n_patch = cfg.frontend.num_patches
        extra = {"patches": torch.from_numpy(rng.standard_normal(
            (batch, n_patch, cfg.frontend.frontend_dim), np.float32)).to(dev)}
    scfg = ss_lib.ServeConfig(max_seq=n_patch + prompt_len + gen + 8,
                              temperature=temperature)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    t0 = time.perf_counter()
    out = ss_lib.generate(params, prompt, cfg, scfg, gen,
                          gen=torch.Generator(device=dev).manual_seed(0),
                          extra_batch=extra, timings=timings)
    wall = time.perf_counter() - t0
    prefill_s, steps = timings["prefill"][0], timings["decode"]
    res = {"tokens": out.cpu(), "prefill_s": prefill_s,
           "decode_step_s": steps, "wall_s": wall,
           "prefill_tokens_per_s": batch * (n_patch + prompt_len) / prefill_s,
           "decode_tokens_per_s": (batch * len(steps) / sum(steps)
                                   if steps else None),
           "tokens_per_s": batch * gen / wall}
    if dev.type == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host; the card by default")
    args = ap.parse_args()
    try:
        r = serve(args.arch, reduced=args.reduced, batch=args.batch,
                  prompt_len=args.prompt_len, gen=args.gen,
                  temperature=args.temperature, device=args.device)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    out = r["tokens"]
    dec = r["decode_tokens_per_s"]
    print(f"prefill {args.batch} x {args.prompt_len} tokens in "
          f"{r['prefill_s']:.3f} s ({r['prefill_tokens_per_s']:.1f} tok/s)")
    print(f"decode {len(r['decode_step_s'])} steps in "
          f"{sum(r['decode_step_s']):.3f} s ("
          + ("n/a" if dec is None else f"{dec:.1f}") + " tok/s)")
    print(f"generated {tuple(out.shape)} in {r['wall_s']:.2f}s "
          f"({r['tokens_per_s']:.1f} tok/s incl. prefill)")
    print("first row:", out[0, :16].numpy(), "...")


if __name__ == "__main__":
    main()
