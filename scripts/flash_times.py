#!/usr/bin/env python3
"""Rows 11-13 (`flash_attention`, `flash_attention_fwd_lse`,
`flash_attention_bwd`) timed as phase 6 of chip_smoke.py times them, for
the port under any source tree.

`chip_smoke.flash_shape_times` (CUDA events around back-to-back calls,
torch.profiler's kernel records, the plain version, SDPA beside it, the
bound) applied to the `repro_torch` found under --src, so two versions of
the kernels (a parent commit's, unpacked with `git archive`, and this
one) compare one process after another on one card. Each row's
`records_ms` gives every device record's ms a call: the forward's kernel,
and the backward's dq and dk/dv kernels apart, with PyTorch's rowsum(dO *
O) beside them:

    python3 scripts/flash_times.py --src build/parent/src
    python3 scripts/flash_times.py --src src --head-dims 64,128,256

Shapes: causal (4, 16, 4096, d) for each --head-dims d and --dtypes
dtype. Prints the card's name and power limit, then one JSON line per
row. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="the directory that holds repro_torch")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--head-dims", default="64")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, os.path.dirname(HERE))
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    b, h, s, _ = cs.FLASH_PATH
    for d in (int(x) for x in args.head_dims.split(",")):
        for dt in args.dtypes.split(","):
            rows = cs.flash_shape_times(torch, ops, ref, (b, h, s, d),
                                        getattr(torch, dt), args.reps)
            for name, row in rows.items():
                print(json.dumps({"src": args.src, "name": name, **row}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
