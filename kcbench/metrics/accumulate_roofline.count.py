"""accumulate_roofline.count: the fused run-boundary and run-total sweep's
(`segment_accumulate_kernel`, every L3 compressor's accumulate and the
store's final histogram) share of its HBM roofline, in the count cells
(whole count_kmers jobs). The meter wraps `ops.segment_accumulate` in the
metered unit (`METER`); the arithmetic is `kcbench.readers.kernel_roofline`.

Least bytes of a call (`accumulate_bytes`): every key's 8 B read (a
sentinel has to be read to be skipped) and, where weights are given, every
weight's 4 B; then what the kernel writes. Compacting, that is each run's
key (8 B) and count (4 B) and each row's run count (4 B): the slots past a
row's runs are filled before the launch, by another kernel. Otherwise it
is two 1-B flags and a 4-B total for every element. The reads of a
neighbouring key and the scan's tile descriptors are left out, so the
count is a lower bound."""

import torch

from kcbench.readers import kernel_roofline

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = ("L3 compressor and super-k-mer segmentation "
         "(fabsp._l3_split_dual, core/minimizer.py)")
MOVES = "kmer_rate"


def accumulate_runs(sorted_keys, weights, *a, **kw):
    """What the meter keeps of an `ops.segment_accumulate` call: its rows,
    its elements, whether it is weighted, whether it compacts, and a device
    count of its runs (valid keys unlike the key before them)."""
    new = sorted_keys != kw["sentinel_val"]
    new[:, 1:] &= sorted_keys[:, 1:] != sorted_keys[:, :-1]
    return (sorted_keys.shape[0], sorted_keys.numel(), weights is not None,
            bool(kw.get("compact", False)), torch.count_nonzero(new))


def accumulate_bytes(rows: int, elements: int, weighted: int, compact: int,
                     runs: int) -> int:
    read = (8 + (4 if weighted else 0)) * elements
    if compact:
        return read + 12 * runs + 4 * rows
    return read + 6 * elements


def read(run):
    return kernel_roofline(run, "segment_accumulate", accumulate_bytes)


METER = {"segment_accumulate": accumulate_runs}
