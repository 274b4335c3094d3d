"""Shared by the tests/test_torch_*.py files: run the JAX package in a fresh
subprocess (for 64-bit words or a multi-device mesh) on numpy inputs and
bring its outputs back as numpy arrays.

`body` is Python run after `I` (the inputs, a dict of arrays) is loaded;
it fills the dict `O`, whose entries are saved with np.asarray.
"""

import concurrent.futures
import os
import subprocess
import sys
import textwrap

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

_PRELUDE = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={devices}"
if {x64}:
    os.environ["JAX_ENABLE_X64"] = "1"
import numpy as np
import jax
import jax.numpy as jnp
I = dict(np.load(sys.argv[1]))
O = {{}}
"""

_EPILOGUE = """
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in O.items()})
"""


def run_jax(tmp_dir, body: str, inputs=None, *, x64: bool = False,
            devices: int = 1, timeout: int = 600) -> dict:
    inp = os.path.join(str(tmp_dir), "jax_in.npz")
    out = os.path.join(str(tmp_dir), "jax_out.npz")
    np.savez(inp, **(inputs or {}))
    code = (_PRELUDE.format(devices=devices, x64=x64)
            + textwrap.dedent(body) + _EPILOGUE)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code, inp, out],
                          capture_output=True, text=True, env=env,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def run_jax_many(tmp_dir, jobs: dict, inputs=None, **kw) -> dict:
    """`run_jax` of several bodies at once, one subprocess each: `jobs`
    maps a name to (body, x64); returns {name: outputs}."""
    dirs = {name: os.path.join(str(tmp_dir), name) for name in jobs}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futs = {name: pool.submit(run_jax, dirs[name], body, inputs,
                                  x64=x64, **kw)
                for name, (body, x64) in jobs.items()}
        return {name: f.result() for name, f in futs.items()}


# Helpers of the durability, spill and serving tests (test_torch_checkpoint,
# test_torch_spill, test_torch_durability, test_torch_serve).

JAX_HELPERS = """
import json
from jax.sharding import Mesh

def put(key, tup):
    O[key] = np.array([float(x) for x in tup], np.float64)

def res_out(key, res):
    O[key + "_u"], O[key + "_c"] = res.unique, res.counts
    O[key + "_n"] = res.num_unique

def mesh_of(p, grid=None):
    if grid is None:
        return Mesh(np.array(jax.devices()[:p]), ("pe",)), ("pe",)
    return (Mesh(np.array(jax.devices()[:p]).reshape(grid), ("row", "col")),
            ("row", "col"))
"""


def assert_stats(got, want):
    """A port stats NamedTuple against the JAX one `put` saved."""
    assert len(got) == len(want)
    for field, g, w in zip(got._fields, got, want):
        assert float(g) == w, field


def assert_result(res, word_bits, jax_out, key):
    """A port AccumResult against the JAX one `res_out` saved."""
    from repro_torch import words as W
    np.testing.assert_array_equal(W.to_numpy_words(res.unique, word_bits),
                                  jax_out[key + "_u"])
    np.testing.assert_array_equal(res.counts.cpu().numpy(),
                                  jax_out[key + "_c"])
    np.testing.assert_array_equal(res.num_unique.cpu().numpy(),
                                  jax_out[key + "_n"])


def histogram(res, num_pes) -> dict:
    """{word: count} of a port AccumResult of `num_pes` PEs."""
    import torch
    L = res.unique.numel() // num_pes
    live = torch.arange(L)[None, :] < res.num_unique[:, None]
    return dict(zip(res.unique.view(num_pes, L)[live].tolist(),
                    res.counts.view(num_pes, L)[live].tolist()))


def segments_of(spill_dir) -> list:
    """The committed segments of a spill directory's manifest, without the
    CRC (np.savez stamps each zip entry with the time)."""
    import json
    with open(os.path.join(str(spill_dir), "manifest.json")) as f:
        man = json.load(f)
    return [{k: v for k, v in s.items() if k != "crc"}
            for s in man["segments"]]


def assert_same_segments(dir_a, dir_b):
    """Two spill directories list the same segments (bin, kind, n, bytes,
    file name) and hold the same arrays in each."""
    sa, sb = segments_of(dir_a), segments_of(dir_b)
    assert sa == sb
    for seg in sa:
        with np.load(os.path.join(str(dir_a), seg["file"])) as za, \
                np.load(os.path.join(str(dir_b), seg["file"])) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for name in za.files:
                assert za[name].dtype == zb[name].dtype, name
                np.testing.assert_array_equal(za[name], zb[name])
