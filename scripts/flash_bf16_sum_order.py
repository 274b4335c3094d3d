#!/usr/bin/env python3
"""How far two correct bf16 flash computations can differ.

Runs the plain versions `ref.flash_fwd` / `ref.flash_bwd` twice on the same
bf16 inputs, the second time with the head dimension permuted (the same
scores and products, summed in another f32 order), and prints, per output,
the largest ratio of |difference| to two bounds:
  value bound: 2**-7 |value| + 1e-4 max|value|  (one bf16 step of the value)
  term bound:  the value bound + 2**-7 x ref.flash_rounded_terms (one bf16
               step of each term whose factor, p or ds, is rounded to bf16)
A ratio above 1 misses the bound. Runs on the CPU in a few seconds:

    PYTHONPATH=src python scripts/flash_bf16_sum_order.py
"""

import torch

from repro_torch.kernels import ref

# (name, b, hq, hkv, sq, skv, causal, window, softcap, q_offset)
CASES = [
    ("noncausal 128 x 128", 1, 1, 1, 128, 128, False, None, None, 0),
    ("GQA 4/2, causal, 200 rows", 2, 4, 2, 200, 200, True, None, None, 0),
    ("window 48, softcap 20", 1, 2, 2, 130, 130, True, 48, 20.0, 0),
    ("q_offset 77, 200 x 277", 1, 4, 2, 200, 277, True, None, None, 77),
    ("seq 1000, causal", 1, 2, 2, 1000, 1000, True, None, None, 0),
]


def ratios(got, want, terms):
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    value = 2.0 ** -7 * w.abs() + 1e-4 * float(w.abs().max())
    return (float((diff / value).max()),
            float((diff / (value + 2.0 ** -7 * terms)).max()))


def main():
    torch.manual_seed(0)
    print("case, d: output value-bound-ratio term-bound-ratio ...")
    for name, b, hq, hkv, sq, skv, causal, window, softcap, qo in CASES:
        for d in (64, 128, 256):
            q, do = (torch.randn(b, hq, sq, d).bfloat16() for _ in range(2))
            k, v = (torch.randn(b, hkv, skv, d).bfloat16() for _ in range(2))
            band = dict(causal=causal, window=window, softcap=softcap,
                        q_offset=qo, scale=d ** -0.5)
            perm = torch.randperm(d)
            inv = torch.argsort(perm)
            o, lse = ref.flash_fwd(q, k, v, with_lse=True, **band)
            o2 = ref.flash_fwd(q[..., perm], k[..., perm], v, **band)
            kq = k.repeat_interleave(hq // hkv, 1)
            vq = v.repeat_interleave(hq // hkv, 1)
            grads = ref.flash_bwd(q, kq, vq, o, lse, do, **band)
            grads2 = ref.flash_bwd(q[..., perm], kq[..., perm],
                                   vq[..., perm], o[..., perm], lse,
                                   do[..., perm], **band)
            terms = ref.flash_rounded_terms(q, kq, vq, o, lse, do, **band)
            pairs = [("o", o2, o, terms[0])]
            pairs += [(n, g2[..., inv], g, t) for n, g2, g, t in zip(
                ("dq", "dk", "dv"), grads2, grads, terms[1:])]
            print(f"{name}, d={d}: " + "  ".join(
                "{} {:.3g} {:.3g}".format(n, *ratios(got, want, t))
                for n, got, want, t in pairs), flush=True)

if __name__ == "__main__":
    main()
