"""End-to-end LM training on one device: the entry point of the LM path.

Config registry -> seeded init -> synthetic Zipf token pipeline (prefetched)
-> train step (microbatched, remat'd, AdamW) -> per-step metrics. It runs on
the CUDA card unless the caller passes device="cpu"; under
attn_impl='flash_train' every layer's attention goes through the flash
forward and backward kernels.

Left out, unlike `repro.launch.train`: checkpoints and resume, the
straggler watchdog and the device mesh (ROADMAP.md section 1, items 10 and
12).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 10 --batch 4 --seq 4096 --attn-impl flash_train
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --steps 5 --batch 2 --seq 64 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.fabsp import resolve_device
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.models import model as model_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib


def train(arch: str, *, reduced: bool, steps: int, batch: int, seq: int,
          microbatches: int = 1, peak_lr: float = 3e-4, log_every: int = 10,
          device=None, **cfg_overrides) -> dict:
    """Train `arch` (reduced or at full size, with ModelConfig overrides
    such as attn_impl='flash_train') for `steps` steps of `batch` sequences
    of `seq` tokens. Returns per-step losses, grad norms and wall seconds
    (host clock, synchronised at the end of every step), the whole run's
    wall seconds, the final loss and the parameter count."""
    dev = resolve_device(device)
    cfg = (reduced_config(arch, **cfg_overrides) if reduced
           else dataclasses.replace(get_config(arch), **cfg_overrides))
    params = model_lib.init_params(cfg, seed=0, device=dev)
    opt_state = opt_lib.init(params)
    tcfg = ts_lib.TrainConfig(
        num_microbatches=microbatches,
        optimizer=opt_lib.OptimizerConfig(peak_lr=peak_lr,
                                          warmup_steps=max(2, steps // 20),
                                          total_steps=steps))
    step_fn = ts_lib.make_train_step(cfg, tcfg)
    pipe = TokenPipeline(TokenPipelineConfig(vocab_size=cfg.vocab_size,
                                             batch_size=batch, seq_len=seq,
                                             seed=0))
    out = {"losses": [], "grad_norms": [], "step_seconds": []}
    t_start = time.perf_counter()
    try:
        for i in range(steps):
            t0 = time.perf_counter()
            _, tokens = pipe.next_batch()
            tok = torch.from_numpy(tokens).to(dev)
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 {"tokens": tok})
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out["step_seconds"].append(time.perf_counter() - t0)
            out["losses"].append(loss)
            out["grad_norms"].append(gnorm)
            if (i + 1) % log_every == 0:
                print(f"step {i + 1:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                      f"lr {metrics['lr']:.2e} "
                      f"{out['step_seconds'][-1]:.3f} s", flush=True)
    finally:
        pipe.close()
    out["wall_seconds"] = time.perf_counter() - t_start
    out["final_loss"] = out["losses"][-1] if out["losses"] else None
    out["n_params"] = sum(p.numel() for _, p in model_lib.named_leaves(params))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--attn-impl", default="flash_train",
                    choices=("flash_train", "ref"))
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host; the card by default")
    args = ap.parse_args()
    out = train(args.arch, reduced=args.reduced, steps=args.steps,
                batch=args.batch, seq=args.seq,
                microbatches=args.microbatches, peak_lr=args.lr,
                log_every=1, device=args.device, attn_impl=args.attn_impl)
    print(f"done: final_loss={out['final_loss']:.4f} "
          f"wall={out['wall_seconds']:.1f}s")


if __name__ == "__main__":
    main()
