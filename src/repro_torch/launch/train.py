"""End-to-end LM training: the entry point of the LM path.

Config registry -> seeded init -> synthetic Zipf token pipeline (prefetched,
resumable) -> train step (microbatched, remat'd, AdamW) -> async
checkpoints -> straggler watchdog -> resume. Counterpart of
`repro.launch.train`. It runs on the CUDA card unless the caller passes
device="cpu"; under attn_impl='flash_train' every layer's attention goes
through the flash forward and backward kernels.

Checkpoints are in the JAX package's layout (blocks stacked per slot, the
AdamW step a 0-d int32), so a checkpoint written by either trainer resumes
under the other.

Across ranks (`group=`, a `core.dist.Group`, one process a rank): the
ranks form a (data, model) mesh with `model_parallel` ranks a row
(`build_mesh`, `launch.mesh.mesh_group`), each holds its block of every
parameter and AdamW moment (`sharding.shard_params`) and its rows of each
global batch along `data`, and the dense decoders run the sharded step
(`train/sharded.py`), every family of the registry. Checkpoints stay
whole and in the JAX layout: gathered on save (rank 0 writes), sliced on
restore, so a checkpoint of any mesh resumes on any other or on one
process.

A VLM's batch holds patches before its tokens, an encoder's frames and
frame labels (the step's tokens): features drawn from a generator seeded
by the step (`step_batch`), so a resumed run sees the same batches.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 10 --batch 4 --seq 4096 --attn-impl flash_train
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --steps 5 --batch 2 --seq 64 --device cpu \\
        --ckpt-dir /tmp/ckpt --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --steps 3 --batch 8 --seq 32 --world 4 \\
        --model-parallel 2 --backend gloo      # 4 ranks on a (2, 2) mesh
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.fabsp import resolve_device
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.core import dist
from repro_torch.launch.mesh import Mesh, mesh_group
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.models import sharding as shd
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import elastic
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import sharded
from repro_torch.train import train_step as ts_lib


def build_mesh(model_parallel: int, devices: Sequence) -> Mesh:
    """`elastic.remesh` over `devices` (devices, or the ranks of a
    group): (data, model) with `model_parallel` a row."""
    devs = list(devices)
    return elastic.remesh(devs, model_parallel=min(model_parallel,
                                                   len(devs)))


def step_batch(cfg, tokens: np.ndarray, step: int) -> Dict[str, np.ndarray]:
    """Step `step`'s batch of `cfg`'s inputs from its (B, S) tokens: the
    tokens; a VLM's (B, num_patches, frontend_dim) patches with them; an
    encoder's (B, S, frontend_dim) frames with the tokens as frame labels.
    The features are standard normals from a generator seeded by the
    step."""
    kind = cfg.frontend.kind
    if kind == "none":
        return {"tokens": tokens}
    rng = np.random.default_rng((1, step))
    b, s = tokens.shape
    f = cfg.frontend
    if kind == "vision":
        return {"tokens": tokens, "patches": rng.standard_normal(
            (b, f.num_patches, f.frontend_dim), np.float32)}
    return {"frames": rng.standard_normal((b, s, f.frontend_dim),
                                          np.float32),
            "labels": tokens}


def train(arch: str, *, reduced: bool, steps: int, batch: int, seq: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          model_parallel: int = 1, microbatches: int = 1,
          peak_lr: float = 3e-4, log_every: int = 10, resume: bool = True,
          device=None, group=None, **cfg_overrides) -> dict:
    """Train `arch` (reduced or at full size, with ModelConfig overrides
    such as attn_impl='flash_train') up to step `steps` on batches of
    `batch` sequences of `seq` tokens.

    With `ckpt_dir`, it resumes from the newest checkpoint there (unless
    `resume` is False) at its cursor, saves every `ckpt_every` steps and at
    the last step, and saves early when the straggler watchdog trips.
    Returns the per-step losses, grad norms, MoE aux losses and seconds
    (host clock,
    synchronised at the end of every step, a save included), the whole
    run's wall seconds, the final loss, the parameter count, the step it
    started at, the watchdog's straggler events, the seconds the resume's
    restore took (None without one), each save's (step, seconds the loop
    was blocked), each background write's (step, seconds), and the
    seconds the closing wait for the last write blocked; and the final
    `params` and `opt_state` (this rank's blocks under a group).

    `group`: every rank calls `train` with the same arguments (module
    docstring); `device` must then be of the group's kind. The batch must
    divide into `microbatches` over the `data` axis: a rank holds its
    block of each microbatch, as the JAX step splits them. The result's `collective_calls` and
    `collective_bytes` hold the sharded step's collectives a step."""
    dev = (resolve_device(device) if group is None
           else dist.resolve_device(group, device))
    cfg = (reduced_config(arch, **cfg_overrides) if reduced
           else dataclasses.replace(get_config(arch), **cfg_overrides))
    mg = None
    if group is not None:
        mg = mesh_group(build_mesh(model_parallel, range(group.world)),
                        group)
    else:
        build_mesh(model_parallel, [dev])
    params = model_lib.init_params(cfg, seed=0, device=dev)
    # the full leaves' shapes, as meta tensors (`param_shardings` reads them)
    shapes = model_lib.map_leaves(
        lambda t: torch.empty(t.shape, device="meta"), params)
    n_params = sum(p.numel() for _, p in model_lib.named_leaves(params))
    if mg is not None:
        params = shd.shard_params(params, mg.mesh, mg.coord)
    opt_state = opt_lib.init(params)
    tcfg = ts_lib.TrainConfig(
        num_microbatches=microbatches,
        optimizer=opt_lib.OptimizerConfig(peak_lr=peak_lr,
                                          warmup_steps=max(2, steps // 20),
                                          total_steps=steps))
    if mg is None:
        step_fn = ts_lib.make_train_step(cfg, tcfg)
    else:
        step_fn = sharded.ShardedStep(cfg, tcfg, mg, shapes)
        n_data = mg.mesh.shape["data"]
        if batch % (n_data * microbatches):
            raise ValueError(f"batch {batch} does not split into "
                             f"{microbatches} microbatches over "
                             f"{n_data} data rows")

        def my_rows(v: np.ndarray) -> np.ndarray:
            """This rank's block of `data` in each microbatch, as the
            JAX step splits each global microbatch over `data`."""
            split = v.reshape(microbatches, n_data, -1, *v.shape[1:])
            return split[:, mg.coord["data"]].reshape(-1, *v.shape[1:])

    def whole(tree):
        """A parameter-shaped tree of this rank's blocks -> whole leaves
        (every rank takes part; on one process or a one-rank mesh the
        blocks are whole already)."""
        if mg is None or mg.mesh.size == 1:
            return tree
        return shd.gather_params(tree, shapes, mg.mesh,
                                 group)

    def mine(tree):
        return tree if mg is None else shd.shard_params(tree, mg.mesh,
                                                        mg.coord)

    start_step, restore_s = 0, None
    last = None if ckpt_dir is None else ckpt_lib.latest_step(ckpt_dir)
    if resume and last is not None:
        t0 = time.perf_counter()
        tmpl = convert.jax_template(params, cfg)
        restored, extra = ckpt_lib.restore(
            ckpt_dir, last, {"params": tmpl, "opt": opt_lib.OptState(
                step=0, mu=tmpl, nu=tmpl)})
        del params, opt_state
        params = mine(convert.params_from_jax(restored["params"], cfg, dev))
        ost = convert.opt_state_from_jax(restored["opt"], cfg, dev)
        opt_state = opt_lib.OptState(step=ost.step, mu=mine(ost.mu),
                                     nu=mine(ost.nu))
        del restored, ost
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        start_step = extra["cursor"]
        print(f"resumed from step {last} (cursor {start_step})")

    pipe = TokenPipeline(TokenPipelineConfig(vocab_size=cfg.vocab_size,
                                             batch_size=batch, seq_len=seq,
                                             seed=0), start_step=start_step)
    lead = group is None or group.rank == 0
    saver = (None if ckpt_dir is None or not lead
             else ckpt_lib.AsyncSaver(ckpt_dir))
    watchdog = elastic.StragglerWatchdog()
    out = {"losses": [], "grad_norms": [], "aux_losses": [],
           "step_seconds": [],
           "save_seconds": [], "collective_calls": [],
           "collective_bytes": []}

    def save(step: int, cursor: int) -> None:
        t0 = time.perf_counter()
        state = opt_lib.OptState(step=opt_state.step,
                                 mu=whole(opt_state.mu),
                                 nu=whole(opt_state.nu))
        trees = convert.checkpoint_trees(whole(params), state, cfg)
        if saver is not None:
            saver.save(step, trees, extra={"cursor": cursor})
        del trees, state
        out["save_seconds"].append((step, time.perf_counter() - t0))

    t_start = time.perf_counter()
    try:
        for i in range(start_step, steps):
            t0 = time.perf_counter()
            watchdog.step_start()
            step_idx, tokens = pipe.next_batch()
            arrays = step_batch(cfg, tokens, step_idx)
            if mg is not None:
                arrays = {k: my_rows(v) for k, v in arrays.items()}
            feed = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
            coll = (None if mg is None
                    else dict(step_fn.collectives))
            params, opt_state, metrics = step_fn(params, opt_state, feed)
            if coll is not None:
                for key in ("calls", "bytes"):
                    out["collective_" + key].append(
                        step_fn.collectives[key] - coll.get(key, 0))
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            tripped = watchdog.step_end(i)
            out["losses"].append(loss)
            out["grad_norms"].append(gnorm)
            out["aux_losses"].append(float(metrics["aux_loss"]))
            if mg is not None and ckpt_dir is not None:
                # a save is collective: every rank trips with rank 0's clock
                tripped = bool(dist.broadcast_object(tripped, group))
            if tripped:
                print(f"[watchdog] sustained stragglers at step {i}"
                      + ("; checkpointing early" if ckpt_dir else ""),
                      flush=True)
                if ckpt_dir is not None:
                    save(i, step_idx + 1)
            if ckpt_dir is not None and ((i + 1) % ckpt_every == 0
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
        if mg is not None:
            mg.destroy()
    out["wall_seconds"] = time.perf_counter() - t_start
    out["final_loss"] = out["losses"][-1] if out["losses"] else None
    out["n_params"] = n_params
    out["start_step"] = start_step
    out["straggler_events"] = len(watchdog.events)
    out["restore_seconds"] = restore_s
    out["write_seconds"] = [] if saver is None else saver.write_seconds
    out["params"], out["opt_state"] = params, opt_state
    return out


def _rank_main(rank: int, world: int, backend: str, init_method: str,
               kw: dict) -> None:
    """One rank of `--world`: join the group, train, leave."""
    g = dist.init_group(backend, init_method, rank, world)
    try:
        out = train(group=g, **kw)
        if rank == 0:
            _report(out)
    finally:
        g.destroy()


def _report(out: dict) -> None:
    final = ("none (no step left to take)" if out["final_loss"] is None
             else f"{out['final_loss']:.4f}")
    print(f"done: final_loss={final} wall={out['wall_seconds']:.1f}s "
          f"straggler_events={out['straggler_events']}")


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
    ap.add_argument("--world", type=int, default=None,
                    help="train on this many ranks, one process each, on "
                         "a (world / model-parallel, model-parallel) mesh")
    ap.add_argument("--rank", type=int, default=None,
                    help="with --init-method: be this one rank of --world "
                         "(started by the caller); else all are spawned")
    ap.add_argument("--init-method", default=None,
                    help="the group's rendezvous URL (a file:// path or "
                         "tcp://localhost:PORT); a temporary file:// store "
                         "when spawning")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="'gloo' on the CPU, 'nccl' one card a rank")
    args = ap.parse_args()
    kw = dict(arch=args.arch, reduced=args.reduced, steps=args.steps,
              batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, model_parallel=args.model_parallel,
              microbatches=args.microbatches, peak_lr=args.lr, log_every=1,
              attn_impl=args.attn_impl)
    if args.world is None:
        _report(train(device=args.device, **kw))
        return
    if args.rank is not None:
        if args.init_method is None:
            ap.error("--rank needs --init-method")
        _rank_main(args.rank, args.world, args.backend, args.init_method,
                   kw)
        return
    with tempfile.TemporaryDirectory() as tmp:
        url = args.init_method or "file://" + os.path.join(tmp, "store")
        torch.multiprocessing.spawn(
            _rank_main, args=(args.world, args.backend, url, kw),
            nprocs=args.world, join=True)


if __name__ == "__main__":
    main()
