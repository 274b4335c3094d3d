"""Analytical model of k-mer counting (paper Section V, Eqs. 9-18), the
port's copy of `repro.core.analytical_model`.

Two-phase decomposition with per-phase compute / intranode-memory /
internode-link terms, and the 'Sum' vs 'Max' overlap variants of Eq.
14/15. Parameterized for the paper's Phoenix Intel nodes (Table IV) and
for the port's card, one NVIDIA H100 SXM (`H100_SXM`), where HBM plays
the memory level and NVLink the NIC.

All formulas follow the paper exactly; `kmer_word_bits` is the paper's
2^ceil(log2 2k) k-mer word width in bits (k=31 -> 64).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict


@dataclasses.dataclass(frozen=True)
class MachineParams:
    """Paper Table IV."""
    name: str
    c_node: float      # peak int64 ops/s per node (GOp/s -> ops/s)
    beta_mem: float    # memory bandwidth per node, bytes/s
    z_cache: float     # fast memory, bytes
    line: float        # cache line, bytes
    beta_link: float   # combined bidirectional NIC bandwidth per node, bytes/s


PHOENIX_INTEL = MachineParams(
    name="phoenix-intel",
    c_node=121.9e9, beta_mem=46.9e9, z_cache=38e6, line=64.0,
    beta_link=12.5e9)

# One NVIDIA H100 SXM as the 'node', for the card the port runs on
# (`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`:
# "NVIDIA H100 80GB HBM3, 700.00 W"; the data sheet's rates assume the
# full 700 W limit).
H100_SXM = MachineParams(
    name="h100-sxm",
    # 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock = 1.673e13 32-bit
    # integer ops/s; a 64-bit add or shift takes two 32-bit instructions.
    c_node=132 * 64 * 1.98e9 / 2,
    # HBM3, 3.35 TB/s (data sheet).
    beta_mem=3.35e12,
    # the 50 MB L2 cache (data sheet).
    z_cache=50e6,
    # an L2 line: 128 B, four 32-B sectors.
    line=128.0,
    # NVLink 4: 18 links x 50 GB/s = 900 GB/s, both directions together
    # (data sheet).
    beta_link=900e9)


def kmer_word_bits(k: int) -> int:
    """2^ceil(log2 (2k)) bits -- the paper's 2-bit-packed word width."""
    return 1 << math.ceil(math.log2(2 * k))


@dataclasses.dataclass(frozen=True)
class Workload:
    n_reads: int     # n
    read_len: int    # m
    k: int
    num_nodes: int   # P (paper counts nodes; cores folded into c_node)

    @property
    def kmers(self) -> int:
        return self.n_reads * (self.read_len - self.k + 1)

    @property
    def kmer_bytes(self) -> int:
        return kmer_word_bits(self.k) // 8


def phase1_compute(w: Workload, m: MachineParams) -> float:
    """Eq. 9: one op per generated k-mer per node."""
    return w.kmers / (w.num_nodes * m.c_node)


def phase1_intranode(w: Workload, m: MachineParams) -> float:
    """Eq. 10: read-parse misses + k-mer store misses."""
    read_miss = 1 + (w.read_len * w.n_reads) / (w.num_nodes * m.line)
    store_miss = 1 + (w.kmers * w.kmer_bytes) / (w.num_nodes * m.line)
    return (read_miss + store_miss) * m.line / m.beta_mem


def phase1_internode(w: Workload, m: MachineParams) -> float:
    """Eq. 11: n(m-k+1)*wordbits / (4 * P * beta_link).

    wordbits/8 bytes per k-mer, x2 because the NIC carries both the send and
    the receive stream -> 2 * kmer_bytes per k-mer per node pair of transfers.
    """
    return (2 * w.kmers * w.kmer_bytes) / (w.num_nodes * m.beta_link)


def phase2_compute(w: Workload, m: MachineParams) -> float:
    """Eq. 12: radix-sort passes (one per byte of the word)."""
    return (w.kmers * w.kmer_bytes) / (w.num_nodes * m.c_node)


def phase2_intranode(w: Workload, m: MachineParams) -> float:
    """Eq. 13: one streaming pass over the data per radix digit-byte."""
    passes = w.kmer_bytes
    miss = 1 + (w.kmers * w.kmer_bytes) / (w.num_nodes * m.line)
    return miss * passes * m.line / m.beta_mem


def predict(w: Workload, m: MachineParams, overlap: str = "max"
            ) -> Dict[str, float]:
    """Full model (Eqs. 14-18). overlap in {'sum', 'max'} (Eq. 14 vs 15)."""
    t_c1 = phase1_compute(w, m)
    t_m1 = phase1_intranode(w, m)
    t_n1 = phase1_internode(w, m)
    t_c2 = phase2_compute(w, m)
    t_m2 = phase2_intranode(w, m)
    if overlap == "sum":
        t_comm1 = t_m1 + t_n1
    elif overlap == "max":
        t_comm1 = max(t_m1, t_n1)
    else:
        raise ValueError(overlap)
    t1 = max(t_c1, t_comm1)
    t2 = max(t_c2, t_m2)
    return {
        "phase1_compute": t_c1,
        "phase1_intranode": t_m1,
        "phase1_internode": t_n1,
        "phase2_compute": t_c2,
        "phase2_intranode": t_m2,
        "phase1_total": t1,
        "phase2_total": t2,
        "total": t1 + t2,  # Eq. 18: global barrier forbids phase overlap
    }


def cache_misses(w: Workload, m: MachineParams) -> Dict[str, float]:
    """Last-level miss counts per node (Fig. 3 reproduction)."""
    p1 = (1 + (w.read_len * w.n_reads) / (w.num_nodes * m.line)
          + 1 + (w.kmers * w.kmer_bytes) / (w.num_nodes * m.line))
    p2 = (1 + (w.kmers * w.kmer_bytes) / (w.num_nodes * m.line)) * w.kmer_bytes
    return {"phase1": p1, "phase2": p2}


def op_intensity(w: Workload) -> float:
    """Paper Sec. VII: ~0.12 iadd64/byte for DAKC -- the roofline argument.

    ops = generate (1/kmer) + sort passes (word_bytes/kmer);
    bytes = parse + store + wire + sort streaming traffic.
    """
    ops = w.kmers * (1 + w.kmer_bytes)
    bytes_moved = (w.n_reads * w.read_len              # parse
                   + w.kmers * w.kmer_bytes            # store
                   + 2 * w.kmers * w.kmer_bytes        # NIC in+out
                   + w.kmers * w.kmer_bytes * w.kmer_bytes)  # radix passes
    return ops / bytes_moved
