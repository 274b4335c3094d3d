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
