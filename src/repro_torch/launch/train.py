"""End-to-end LM training on one device: the entry point of the LM path.

Config registry -> seeded init -> synthetic Zipf token pipeline (prefetched,
resumable) -> train step (microbatched, remat'd, AdamW) -> async
checkpoints -> straggler watchdog -> resume. Counterpart of
`repro.launch.train`. It runs on the CUDA card unless the caller passes
device="cpu"; under attn_impl='flash_train' every layer's attention goes
through the flash forward and backward kernels.

Checkpoints are in the JAX package's layout (blocks stacked per slot, the
AdamW step a 0-d int32), so a checkpoint written by either trainer resumes
under the other. The mesh is built over the one device the step runs on:
a mesh of more than one device raises, as the port has no multi-device
step yet (ROADMAP.md section 1, item 13).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 10 --batch 4 --seq 4096 --attn-impl flash_train
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --steps 5 --batch 2 --seq 64 --device cpu \\
        --ckpt-dir /tmp/ckpt --ckpt-every 2
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.fabsp import resolve_device
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import elastic
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib


def build_mesh(model_parallel: int, devices: Sequence) -> Mesh:
    """`elastic.remesh` over `devices`; raises NotImplementedError for a
    mesh of more than one device."""
    devs = list(devices)
    mesh = elastic.remesh(devs, model_parallel=min(model_parallel, len(devs)))
    if mesh.size > 1:
        raise NotImplementedError(
            f"a mesh of {mesh.size} devices: the port trains on one device "
            "until PEs and shards run across processes (ROADMAP.md "
            "section 1, item 13)")
    return mesh


def train(arch: str, *, reduced: bool, steps: int, batch: int, seq: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          model_parallel: int = 1, microbatches: int = 1,
          peak_lr: float = 3e-4, log_every: int = 10, resume: bool = True,
          device=None, **cfg_overrides) -> dict:
    """Train `arch` (reduced or at full size, with ModelConfig overrides
    such as attn_impl='flash_train') up to step `steps` on batches of
    `batch` sequences of `seq` tokens.

    With `ckpt_dir`, it resumes from the newest checkpoint there (unless
    `resume` is False) at its cursor, saves every `ckpt_every` steps and at
    the last step, and saves early when the straggler watchdog trips.
    Returns the per-step losses, grad norms and seconds (host clock,
    synchronised at the end of every step, a save included), the whole
    run's wall seconds, the final loss, the parameter count, the step it
    started at, the watchdog's straggler events, the seconds the resume's
    restore took (None without one), each save's (step, seconds the loop
    was blocked), each background write's (step, seconds), and the
    seconds the closing wait for the last write blocked; and the final
    `params` and `opt_state`."""
    dev = resolve_device(device)
    cfg = (reduced_config(arch, **cfg_overrides) if reduced
           else dataclasses.replace(get_config(arch), **cfg_overrides))
    build_mesh(model_parallel, [dev])
    params = model_lib.init_params(cfg, seed=0, device=dev)
    opt_state = opt_lib.init(params)
    tcfg = ts_lib.TrainConfig(
        num_microbatches=microbatches,
        optimizer=opt_lib.OptimizerConfig(peak_lr=peak_lr,
                                          warmup_steps=max(2, steps // 20),
                                          total_steps=steps))
    step_fn = ts_lib.make_train_step(cfg, tcfg)

    start_step, restore_s = 0, None
    last = None if ckpt_dir is None else ckpt_lib.latest_step(ckpt_dir)
    if resume and last is not None:
        t0 = time.perf_counter()
        tmpl = convert.jax_template(params, cfg)
        restored, extra = ckpt_lib.restore(
            ckpt_dir, last, {"params": tmpl, "opt": opt_lib.OptState(
                step=0, mu=tmpl, nu=tmpl)})
        del params, opt_state
        params = convert.params_from_jax(restored["params"], cfg, dev)
        opt_state = convert.opt_state_from_jax(restored["opt"], cfg, dev)
        del restored
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        start_step = extra["cursor"]
        print(f"resumed from step {last} (cursor {start_step})")

    pipe = TokenPipeline(TokenPipelineConfig(vocab_size=cfg.vocab_size,
                                             batch_size=batch, seq_len=seq,
                                             seed=0), start_step=start_step)
    saver = None if ckpt_dir is None else ckpt_lib.AsyncSaver(ckpt_dir)
    watchdog = elastic.StragglerWatchdog()
    out = {"losses": [], "grad_norms": [], "step_seconds": [],
           "save_seconds": []}

    def save(step: int, cursor: int) -> None:
        t0 = time.perf_counter()
        saver.save(step, convert.checkpoint_trees(params, opt_state, cfg),
                   extra={"cursor": cursor})
        out["save_seconds"].append((step, time.perf_counter() - t0))

    t_start = time.perf_counter()
    try:
        for i in range(start_step, steps):
            t0 = time.perf_counter()
            watchdog.step_start()
            step_idx, tokens = pipe.next_batch()
            tok = torch.from_numpy(tokens).to(dev)
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 {"tokens": tok})
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            tripped = watchdog.step_end(i)
            out["losses"].append(loss)
            out["grad_norms"].append(gnorm)
            if tripped:
                print(f"[watchdog] sustained stragglers at step {i}"
                      + ("; checkpointing early" if saver else ""),
                      flush=True)
                if saver is not None:
                    save(i, step_idx + 1)
            if saver is not None and ((i + 1) % ckpt_every == 0
                                      or i == steps - 1):
                save(i + 1, step_idx + 1)
            out["step_seconds"].append(time.perf_counter() - t0)
            if (i + 1) % log_every == 0:
                print(f"step {i + 1:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                      f"lr {metrics['lr']:.2e} "
                      f"{out['step_seconds'][-1]:.3f} s", flush=True)
        t0 = time.perf_counter()
        if saver is not None:
            saver.wait()
        out["final_wait_seconds"] = time.perf_counter() - t0
    finally:
        pipe.close()
    out["wall_seconds"] = time.perf_counter() - t_start
    out["final_loss"] = out["losses"][-1] if out["losses"] else None
    out["n_params"] = sum(p.numel() for _, p in model_lib.named_leaves(params))
    out["start_step"] = start_step
    out["straggler_events"] = len(watchdog.events)
    out["restore_seconds"] = restore_s
    out["write_seconds"] = [] if saver is None else saver.write_seconds
    out["params"], out["opt_state"] = params, opt_state
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--ckpt-dir", default=None,
                    help="save and resume here; no checkpoints without it")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--attn-impl", default="flash_train",
                    choices=("flash_train", "ref"))
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host; the card by default")
    args = ap.parse_args()
    out = train(args.arch, reduced=args.reduced, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every,
                model_parallel=args.model_parallel,
                microbatches=args.microbatches, peak_lr=args.lr,
                log_every=1, device=args.device, attn_impl=args.attn_impl)
    final = ("none (no step left to take)" if out["final_loss"] is None
             else f"{out['final_loss']:.4f}")
    print(f"done: final_loss={final} wall={out['wall_seconds']:.1f}s "
          f"straggler_events={out['straggler_events']}")


if __name__ == "__main__":
    main()
