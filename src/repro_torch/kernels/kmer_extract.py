"""k-mer extraction: every length-k window of a read packed into a word.

Counterpart of `repro.kernels.kmer_extract.kmer_extract_pallas`; the CUDA
kernel is `csrc/kmer_extract.cu`, which picks its own tiling. Words are
int64 (see `repro_torch.words`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    "kmer_extract_launch": (_P, _P, _I64, _I64, _INT, _INT, _INT, _P),
}


def kmer_extract_cuda(reads: torch.Tensor, k: int, bits_per_symbol: int,
                      canonical: bool) -> torch.Tensor:
    """(n_reads, m) uint8 codes below 2**bits_per_symbol -> (n_reads,
    m - k + 1) int64 words; with `canonical`, min(forward, reverse
    complement). The caller checks k and bits_per_symbol."""
    build.check_arg(reads, "reads", torch.uint8, 2)
    rows, m = reads.shape
    out = torch.empty((rows, m - k + 1), dtype=torch.int64,
                      device=reads.device)
    if out.numel():
        lib = build.load("kmer_extract", _SIGNATURES)
        build.check_status(lib.kmer_extract_launch(
            reads.data_ptr(), out.data_ptr(), rows, m, k, bits_per_symbol,
            int(canonical), build.stream_ptr(reads)), "kmer_extract")
    return out
