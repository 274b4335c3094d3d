"""The dry-run: every (arch x shape x mesh) cell's per-device step traced
over `meta` tensors (counterpart of `repro.launch.dryrun`).

The JAX module lowers and compiles each cell on 256 or 512 forced host
devices and reads XLA's memory and cost analyses and the collectives of
the partitioned HLO. The port has no XLA, no partitioner and no HLO, so it
runs its own step on `meta` tensors at per-device shapes and counts what
the ops do. For each cell this shows, without a card:
- that the step runs at the cell's per-device shapes;
- the per-device memory: `argument_size_in_bytes` (the parameters,
  optimiser state and inputs, each leaf's bytes over the mesh axes its
  fitted spec shards it on: what one device holds), `temp_size_in_bytes`
  (the peak of the storages the step makes, tracked by weakref as eager
  PyTorch frees them) and `output_size_in_bytes`;
- the per-device cost: `flops` (`torch.utils.flop_counter`'s formulas for
  the products, plus each kernel's count from `kernels/meta.py`) and
  `bytes accessed` (each op's inputs plus outputs: eager PyTorch runs every
  op unfused, so this counts what XLA would fuse away; views move
  nothing and are not counted);
- the collectives, derived from `models/sharding.py`'s specs (below).

The per-device program. `local_config` (`models/sharding.py`, shared
with the sharded train step) divides the cell's config by the
`model` axis wherever the fitted spec shards a dimension on it: heads
(with the KV heads where they divide, else the KV heads the local query
heads read), MLP hidden, vocabulary, experts (with the top-k and capacity
factor set so each local expert keeps the global capacity), the Mamba2
inner width and heads. The batch is divided by the data axes. FSDP weights
are taken gathered, whole along `data`. The step is the port's own:
`train_step.make_train_step` (train cells), `model.forward` (prefill) or
`model.decode_step` plus the argmax (decode).

Depth. The step is traced as it runs: every layer and every microbatch.
Counts that add up (FLOPs, bytes, kernel calls) grow linearly with the
periods, but the peak is a maximum of terms that grow at different rates
(saved activations, gradients, the head's logits), so a shallower trace
cannot be extrapolated to it. A functional op repeated at the same shapes
takes its first call's result (`CostMode`'s memo), so a full-size cell
traces in under a minute on one core (`main --jobs` spreads the cells).

Collectives (per device and step; bytes are result buffers weighted as
the JAX parser weights them: all-reduce 2x its result, reduce-scatter x
its group size; `count` counts executions, where the JAX parser counts
ops in the program text):
- all-gather: each leaf whose spec shards it over `data` (FSDP) is
  gathered whole along `data` (f32, the stored dtype) once a microbatch
  forward, and block leaves again in the backward under remat;
- reduce-scatter: the gradient of each such leaf, once a microbatch;
  all-reduce over `data` for the leaves `data` does not shard;
- all-reduce over `model` (tensor parallelism): the activations after the
  row-parallel products (attention `wo`, the MLP's or experts' `wo`,
  Mamba2's `out_proj`) forward, again under remat and once backward, at
  (local batch, seq, d_model) in the compute dtype;
- the vocab-parallel head: the embedding's partial rows (f32) and, in
  training, the softmax's max and sum (2 f32 a position) forward and the
  head's input gradient backward;
- distributed flash-decode: where the KV cache's sequence is sharded, each
  attention layer's partial outputs and softmax statistics, all-reduced
  over the sequence's axes;
- all-reduce over `pod`: every gradient shard once a step.
There is no HLO parser (ROADMAP section 3).

Results land in <out>/<arch>__<shape>__<mesh>.json, which
`launch/roofline.py` reads.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import meta as meta_kernels
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import Mesh, data_axes_of, make_production_mesh
from repro_torch.models import model as model_lib
from repro_torch.models import sharding as shd
from repro_torch.models.sharding import PartitionSpec as P
from repro_torch.models.sharding import local_config, model_div
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
META = torch.device("meta")
_aten = torch.ops.aten
# Factories that allocate without writing: their storages count as live
# memory, not as bytes accessed.
_ALLOCATORS = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default}


def _flat(tree, out: list) -> list:
    """The leaves of nested tuples, lists and dicts (an op's arguments and
    results), in order; faster than the generic pytree walk."""
    for x in (tree.values() if type(tree) is dict else tree):
        t = type(x)
        if t is tuple or t is list or t is dict:
            _flat(x, out)
        else:
            out.append(x)
    return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for t in _flat(tree, []) if isinstance(t, torch.Tensor)]


def _meta_of(t):
    return ((t.shape, t.stride(), t.dtype)
            if isinstance(t, torch.Tensor) else t)


def _rebuild(m):
    return torch.empty_strided(m[0], m[1], dtype=m[2], device=META)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts what each op dispatched inside it does: FLOPs (the flop
    counter's formulas), bytes accessed (inputs plus outputs of every op
    that is not a view or a bare allocation) and the peak of the storages
    made inside the block that are alive at once. The meta kernels' work
    comes in through `kernels.meta.counting`."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._owned = {}
        self._memo = {}
        self._kinds = {}
        self.kernels = meta_kernels.KernelCost()
        self._counting = meta_kernels.counting(self.kernels)

    def __enter__(self):
        self._counting.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self._counting.__exit__(*exc)
        return super().__exit__(*exc)

    def _free(self, ref) -> None:
        self.live -= self._owned.pop(ref)

    def _track(self, st) -> None:
        n = st.nbytes()
        if not n:
            return
        ref = weakref.ref(st, self._free)
        if ref in self._owned:
            return
        self._owned[ref] = n
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = _flat(args, [])
        if kwargs:
            _flat(kwargs, leaves)
        self.n_ops += 1
        kind = self._kinds.get(func)
        if kind is None:
            mutable = func._schema.is_mutable
            kind = self._kinds[func] = (mutable, not mutable and all(
                r.alias_info is None for r in func._schema.returns))
        mutable, functional = kind
        key = None
        if functional:
            # A functional op's outputs and FLOPs depend on its inputs'
            # metadata alone: the same call again takes the first one's,
            # which saves the meta function's Python (most of a trace).
            key = (func, *[_meta_of(t) for t in leaves])
            try:
                hit = self._memo.get(key)
            except TypeError:            # an unhashable argument
                key, hit = None, None
            if hit is not None:
                flops, nbytes, metas = hit
                if isinstance(metas, list):
                    out = tuple(_rebuild(m) if isinstance(m, tuple) else m
                                for m in metas)
                else:
                    out = _rebuild(metas)
                for t in _tensors(out):
                    self._track(t.untyped_storage())
                self.flops += flops
                self.bytes += nbytes
                return out
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        before = {id(t.untyped_storage()) for t in ins}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        shared = [id(t.untyped_storage()) in before for t in outs]
        # a view (whatever its schema says, as `_unsafe_view`'s does not)
        # moves nothing; an in-place op reads and writes its tensor
        view = bool(outs) and all(shared) and not mutable
        packet = func.overloadpacket
        flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                 if packet in flop_registry else 0)
        nbytes = 0
        if not view and func not in _ALLOCATORS:
            nbytes = sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        self.flops += flops
        self.bytes += nbytes
        for t, s in zip(outs, shared):
            if not s:
                self._track(t.untyped_storage())
        if key is not None and not any(shared) and all(
                t.device.type == "meta" and t.storage_offset() == 0
                for t in outs):
            if isinstance(out, torch.Tensor):
                self._memo[key] = (flops, nbytes, _meta_of(out))
            elif isinstance(out, tuple) and all(
                    not isinstance(x, (tuple, list, dict)) for x in out):
                self._memo[key] = (flops, nbytes, [_meta_of(x) for x in out])
        return out


# --- the per-device program --------------------------------------------------

def _spec_divisor(spec: Optional[P], mesh: Mesh, dim: int) -> int:
    if spec is None or dim >= len(spec) or spec[dim] is None:
        return 1
    e = spec[dim]
    names = e if isinstance(e, (tuple, list)) else (e,)
    return math.prod(mesh.shape[n] for n in names)


def sharded_bytes(t: torch.Tensor, spec: Optional[P], mesh: Mesh,
                  axes=None) -> int:
    """Bytes of one device's shard of `t` under `spec` (every axis, or the
    `axes` named)."""
    n = t.numel() * t.element_size()
    if spec is None:
        return n
    for dim, e in enumerate(spec):
        if e is None:
            continue
        names = e if isinstance(e, (tuple, list)) else (e,)
        for a in names:
            if axes is None or a in axes:
                n //= mesh.shape[a]
    return n


def abstract_state(cfg: ModelConfig, mesh: Mesh):
    """Abstract parameters and AdamW state with production specs: trees of
    `specs.Abstract` (a meta tensor and its fitted spec); the step a 0-d
    int32, replicated (the JAX package's `OptState.step`)."""
    p_meta = model_lib.abstract_params(cfg)

    def attach(tree, path=()):
        if isinstance(tree, dict):
            return {k: attach(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(attach(v, path + (i,))
                              for i, v in enumerate(tree))
        return specs_lib.Abstract(tree, shd.param_spec(path, tree, mesh))

    params = attach(p_meta)
    opt = opt_lib.OptState(
        step=specs_lib.Abstract(torch.empty((), dtype=torch.int32,
                                            device=META), P()),
        mu=attach(p_meta), nu=attach(p_meta))
    return params, opt


def _leaves(tree):
    return [x for x in tree_flatten(tree, is_leaf=lambda x: isinstance(
        x, specs_lib.Abstract))[0] if isinstance(x, specs_lib.Abstract)]


def _tree_bytes(tree, mesh: Mesh) -> int:
    return sum(sharded_bytes(a.tensor, a.spec, mesh) for a in _leaves(tree))


def _depth(cfg: ModelConfig, periods: int) -> ModelConfig:
    return dataclasses.replace(cfg, num_layers=periods * len(cfg.period))


def _trace(fn):
    """(the CostMode of running `fn` inside it, fn's result)."""
    mode = CostMode()
    with mode:
        out = fn()
    return mode, out


def _step_fn(cell, lcfg: ModelConfig, local_batch: int, seq: int,
             cache_len: int, num_microbatches: int):
    """A thunk that builds the local arguments on `meta` (outside the cost
    mode) and returns the traced step."""
    params = model_lib.abstract_params(lcfg)
    if cell.kind != "decode":
        inputs = _local_inputs(lcfg, cell, local_batch, seq)
    if cell.kind == "train":
        opt = opt_lib.init(params)
        step = ts_lib.make_train_step(lcfg, ts_lib.TrainConfig(
            num_microbatches=num_microbatches))
        return lambda: step(params, opt, inputs)
    if cell.kind == "prefill":
        def prefill():
            with torch.no_grad():
                return model_lib.forward(params, inputs, lcfg)[0]
        return prefill
    caches = model_lib.init_caches(lcfg, local_batch, cache_len,
                                   torch.bfloat16, device=META)
    tokens = torch.empty((local_batch, 1), dtype=torch.int32, device=META)

    def decode():
        with torch.no_grad():
            lg, new = model_lib.decode_step(params, tokens, caches,
                                            cache_len - 1, lcfg)
            return torch.argmax(lg[:, -1], dim=-1).to(torch.int32), new
    return decode


def _local_inputs(lcfg: ModelConfig, cell, b: int, s: int) -> dict:
    if lcfg.frontend.kind == "audio":
        return {"frames": torch.empty((b, s, lcfg.frontend.frontend_dim),
                                      device=META),
                "labels": torch.empty((b, s), dtype=torch.int32,
                                      device=META)}
    n_text = s - (lcfg.frontend.num_patches
                  if lcfg.frontend.kind == "vision" else 0)
    out = {"tokens": torch.empty((b, n_text), dtype=torch.int32,
                                 device=META)}
    if lcfg.frontend.kind == "vision":
        out["patches"] = torch.empty(
            (b, lcfg.frontend.num_patches, lcfg.frontend.frontend_dim),
            device=META)
    return out


def _collectives(cfg: ModelConfig, cell, mesh: Mesh, params, *,
                 local_batch: int, seq: int, nm: int,
                 kv_seq_axes=()) -> Dict:
    """The step's collectives from the specs (module docstring)."""
    out = {op: {"bytes": 0.0, "count": 0} for op in COLLECTIVE_OPS}

    def add(op, result_bytes, times, group):
        if group <= 1 or times == 0 or result_bytes == 0:
            return
        wire = result_bytes * (2 if op == "all-reduce" else
                               group if op == "reduce-scatter" else 1)
        out[op]["bytes"] += float(wire * times)
        out[op]["count"] += times

    d_ax, m_ax = mesh.shape.get("data", 1), mesh.shape.get("model", 1)
    pod = mesh.shape.get("pod", 1)
    train = cell.kind == "train"
    remat = train and cfg.remat == "full"
    for path, a in _named_abstract(params):
        in_block = path[0] == "blocks" or path[0] == "shared_attn"
        gathered = sharded_bytes(a.tensor, a.spec, mesh, axes=("model",))
        shard = sharded_bytes(a.tensor, a.spec, mesh)
        data_sharded = shard < gathered
        if data_sharded:
            add("all-gather", gathered,
                nm * (2 if remat and in_block else 1), d_ax)
        if train:
            if data_sharded:
                add("reduce-scatter", shard, nm, d_ax)
            else:
                add("all-reduce", shard, nm, d_ax)
            add("all-reduce", shard, 1, pod)
    cdt_bytes = torch.empty((), dtype=getattr(
        torch, cfg.compute_dtype)).element_size()
    b_mb = local_batch // nm
    act = b_mb * seq * cfg.d_model * cdt_bytes
    tp_times = nm * ((3 if remat else 2) if train else 1)
    for i in range(cfg.num_layers):
        kind = cfg.period[i % len(cfg.period)]
        blocks = {"attn": 2, "attn_local": 2, "moe": 2, "mamba": 1,
                  "mamba_shared_attn": 3}[kind]
        add("all-reduce", act, tp_times * blocks, m_ax)
        if kv_seq_axes and kind != "mamba":
            group = math.prod(mesh.shape[x] for x in kv_seq_axes)
            h_loc = model_div(mesh, cfg.num_heads)
            add("all-reduce", b_mb * h_loc * seq
                * (cfg.resolved_head_dim + 2) * 4, nm, group)
    vocab_sharded = cfg.vocab_size % m_ax == 0
    if vocab_sharded:
        add("all-reduce", b_mb * seq * cfg.d_model * 4, nm, m_ax)
        if train:
            add("all-reduce", b_mb * seq * 2 * 4, nm, m_ax)
            add("all-reduce", act, nm, m_ax)
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def _named_abstract(tree, prefix=()):
    if isinstance(tree, specs_lib.Abstract):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_abstract(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_abstract(v, prefix + (i,))


def _cost_record(mode: CostMode) -> dict:
    return {"flops": float(mode.flops + mode.kernels.ops),
            "bytes accessed": float(mode.bytes + mode.kernels.bytes)}


def lower_cell(arch: str, shape_name, mesh: Mesh, *,
               compile_it: bool = True, num_microbatches: int = 8,
               config: Optional[ModelConfig] = None,
               **cfg_overrides) -> dict:
    """Trace one cell's per-device step (module docstring): `shape_name`
    names a cell of `SHAPES`, or is a `ShapeCell` of its own (the record
    then carries it under 'cell'). `config` replaces `arch`'s config
    (a reduced one, in the tests). With
    `compile_it` False, the counterpart of the JAX `--no-compile`: the step
    is traced one period deep and one microbatch wide, and nothing is
    counted. `cfg_overrides` replace ModelConfig fields, e.g.
    attn_impl='flash_train'."""
    cfg = dataclasses.replace(config or get_config(arch), **cfg_overrides)
    cell = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    batch_axes = data_axes_of(mesh)
    t0 = time.perf_counter()
    params, opt = abstract_state(cfg, mesh)
    kwargs = specs_lib.input_specs(cfg, cell, mesh, batch_axes)
    nm = num_microbatches if cell.kind == "train" else 1

    # per-device shapes: the batch (or a batch-of-one sequence) over the
    # spec's axes
    if cell.kind == "decode":
        tok = kwargs["tokens"]
        local_batch = cell.global_batch // _spec_divisor(tok.spec, mesh, 0)
        kv = next(layer["kv"].k for layer in kwargs["caches"]
                  if "kv" in layer) if any(
            "kv" in layer for layer in kwargs["caches"]) else None
        cache_len = (cell.seq_len if kv is None else
                     cell.seq_len // _spec_divisor(kv.spec, mesh, 2))
        kv_seq_axes = () if kv is None or kv.spec[2] is None else (
            tuple(kv.spec[2]) if isinstance(kv.spec[2], tuple)
            else (kv.spec[2],))
        seq = 1
    else:
        first = next(iter(kwargs["batch"].values()))
        local_batch = cell.global_batch // _spec_divisor(first.spec, mesh, 0)
        cache_len, kv_seq_axes, seq = 0, (), cell.seq_len
    if local_batch % nm:
        raise ValueError(f"local batch {local_batch} does not split into "
                         f"{nm} microbatches")
    lcfg = local_config(cfg, mesh)
    if compile_it:
        fn = _step_fn(cell, lcfg, local_batch, seq, cache_len, nm)
    else:
        fn = _step_fn(cell, _depth(lcfg, 1), local_batch // nm, seq,
                      cache_len, 1)
    mode = _trace(fn)[0]
    del fn
    t_lower = time.perf_counter() - t0
    rec = {
        "arch": arch, "shape": cell.name,
        "mesh": dict(mesh.shape), "kind": cell.kind,
        "lower_seconds": round(t_lower, 2),
        "num_microbatches": num_microbatches if cell.kind == "train" else None,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    }
    if cell.name not in SHAPES:
        rec["cell"] = dataclasses.asdict(cell)
    if not compile_it:
        return rec

    state = _tree_bytes(params, mesh)
    if cell.kind == "train":
        state += _tree_bytes(opt, mesh)
    args = state + _tree_bytes(kwargs, mesh)
    if cell.kind == "train":
        # the new state and the step's four f32 metrics
        outputs = state + 4 * 4
    elif cell.kind == "prefill":
        # the f32 logits, vocab-parallel where the vocabulary divides
        outputs = local_batch * cell.seq_len * 4 * model_div(
            mesh, cfg.vocab_size)
    else:
        outputs = local_batch * 4 + _tree_bytes(kwargs["caches"], mesh)
    rec["memory"] = {
        "argument_size_in_bytes": int(args),
        "output_size_in_bytes": int(outputs),
        "temp_size_in_bytes": int(mode.peak),
    }
    rec["cost"] = _cost_record(mode)
    rec["kernels"] = {
        name: {"calls": int(calls), "ops": float(ops), "bytes": float(nb)}
        for name, (calls, ops, nb) in sorted(mode.kernels.by_kernel.items())}
    rec["ops_dispatched"] = mode.n_ops
    rec["collectives"] = _collectives(
        cfg, cell, mesh, params, local_batch=local_batch, seq=seq, nm=nm,
        kv_seq_axes=kv_seq_axes)
    return rec


def abstract_mesh(multi_pod: bool) -> Mesh:
    """The production mesh over placeholder devices: nothing touches a
    card."""
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod,
                                devices=[f"abstract:{i}" for i in range(n)])


def _run_cell(arch: str, shape_name: str, multi_pod: bool, out: str,
              compile_it: bool, num_microbatches: int):
    """One cell of `main`: (its record, written to its file, and the line
    that reports it)."""
    mesh = abstract_mesh(multi_pod)
    mname = "pod2x16x16" if multi_pod else "pod16x16"
    ok, reason = applicable_shapes(get_config(arch))[shape_name]
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": dict(mesh.shape),
               "skipped": reason}
        line = f"[skip] {arch} {shape_name} {mname}: {reason}"
    else:
        try:
            rec = lower_cell(arch, shape_name, mesh, compile_it=compile_it,
                             num_microbatches=num_microbatches)
            line = (f"[ok]   {arch} {shape_name} {mname} "
                    f"trace={rec['lower_seconds']}s temp="
                    f"{rec.get('memory', {}).get('temp_size_in_bytes', '?')}")
        except Exception as e:
            rec = {"arch": arch, "shape": shape_name,
                   "mesh": dict(mesh.shape), "error": str(e)[-2000:]}
            line = (f"[FAIL] {arch} {shape_name} {mname}: {str(e)[:300]}\n"
                    + traceback.format_exc())
    with open(os.path.join(out, f"{arch}__{shape_name}__{mname}.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    return rec, line


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description="trace every (arch x shape x mesh) cell on meta tensors")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--no-compile", action="store_true",
                    help="trace one period deep, one microbatch wide, and "
                         "count nothing")
    ap.add_argument("--microbatches", type=int, default=8,
                    help="grad-accum microbatches for train cells")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    # the prefill cells, the longest traces, first
    cells = sorted(((arch, shape, multi) for multi in meshes
                    for arch in archs for shape in shapes),
                   key=lambda c: SHAPES[c[1]].kind != "prefill")
    job_args = (args.out, not args.no_compile, args.microbatches)
    recs = []

    def report(rec, line):
        recs.append(rec)
        print(line, flush=True)

    if args.jobs <= 1:
        for c in cells:
            report(*_run_cell(*c, *job_args))
    else:
        import concurrent.futures
        import multiprocessing
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            for fut in concurrent.futures.as_completed(
                    [pool.submit(_run_cell, *c, *job_args) for c in cells]):
                report(*fut.result())
    failures = [(r["arch"], r["shape"], r["mesh"]) for r in recs
                if "error" in r]
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    print("dry-run complete: every cell traced")
    return recs


if __name__ == "__main__":
    main()
