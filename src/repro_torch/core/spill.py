"""The disk spill tier (counterpart of `repro.core.spill`): KMC-style
two-phase counting once the count store outgrows the card.

- Partition phase: every received record gets a bin from a third
  avalanche hash family (`bin_of`), independent of the owner hash and the
  store's slot hash. Under the super-k-mer transport the bin key is the
  slot's minimizer, recovered at the receiver, so nothing more travels on
  the wire. Each chunk's receive lanes stream device -> pinned host memory
  through `AsyncHostCopier` and land in per-bin segment files through
  `SpillWriter`.
- Fold phase: a bin is a pure function of the k-mer, so bins partition
  k-mer space and each is counted on its own; the per-bin histograms
  concatenate into the exact global one (`fabsp.KmerCounter` drains them
  through its elastic fold, so a spilled run restores onto any PE count).

Durability, as in the JAX package: a segment is written tmp-then-rename
with its CRC32 and byte size in the manifest; `read_bin` checks both and
raises the typed `SpillCorrupt`. The manifest lists committed segments
only: a batch's segments stay pending until `commit()`, so a replayed or
killed attempt leaves files the manifest never names, and `attach()` (on
restore) prunes them. Records are spilled exactly once however often a
batch replays.

A spill directory reads the same under either package: the bins are
bit-equal to the JAX package's, and the segments hold the same numpy
dtypes (uint32/uint64 words, int32 counts and lengths), so the manifest's
`n` and `bytes` and the flush boundaries agree too. Only the CRCs differ,
as `np.savez` stamps each zip entry with the time.
"""

from __future__ import annotations

import io
import json
import math
import os
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import words as W
from repro_torch.core import owner, resilience

# Salts of the third avalanche family (bin assignment), the JAX package's:
# independent of the owner family (unsalted) and the slot family.
_BIN_SALT32 = 0x27D4EB2F
_BIN_SALT64 = owner._signed64(0x2545F4914F6CDD1D)

MANIFEST = "manifest.json"


def bin_of(keys: torch.Tensor, n_bins: int, word_bits: int) -> torch.Tensor:
    """Bin ids in [0, n_bins), int32, of int64-carried key words of width
    `word_bits` (any shape).

    Keys are ownership words: the masked k-mer under the k-mer transport,
    the recovered minimizer under the super-k-mer one. The remainder is
    unsigned (`words.umod`): a 64-bit hash with its top bit set is negative
    as int64, and `%` would give another bin than the JAX package's."""
    if word_bits == 64:
        h = owner._mix64(owner._mix64(keys) ^ _BIN_SALT64)
    else:
        h = owner._mix32(owner._mix32(keys) ^ _BIN_SALT32)
    return W.umod(h, n_bins, word_bits).to(torch.int32)


def auto_bins(distinct_est: Optional[int], num_pes: int,
              per_pe_cap: Optional[int], store_slack: float = 1.5, *,
              floor: int = 4, ceiling: int = 4096) -> int:
    """Bin count sized so each bin's drain-time fold fits the per-PE store
    capacity the rehash ladder stopped at: the smallest power of two B with
    distinct_est * store_slack / (P * B) <= per_pe_cap, within [floor,
    ceiling]; 16 when no estimate or capacity is in hand."""
    if distinct_est is None or not per_pe_cap:
        return 16
    need = math.ceil(distinct_est * store_slack / (num_pes * per_pe_cap))
    b = 1 << max(0, int(need) - 1).bit_length()
    return max(floor, min(ceiling, b))


class SpillCorrupt(RuntimeError):
    """A sealed bin segment failed its checksum or size check on read."""

    def __init__(self, msg: str, bin_id: int, file: str):
        super().__init__(msg)
        self.bin = bin_id
        self.file = file


class AsyncHostCopier:
    """Device-to-host staging of receive lanes with bounded host memory.

    `submit(tensors)` starts a copy of each tensor into pinned host memory
    (`non_blocking=True`) and records a CUDA event behind them; it returns
    the batches that must be taken now to respect the byte budget, oldest
    first: at most two batches stay in flight, fewer once their bytes pass
    `budget_bytes`. Taking a batch waits on its own event only, so the card
    computes chunk c + 1 while the host reads chunk c. On CPU tensors the
    copy is a plain one. Batches come back as tuples of host tensors."""

    def __init__(self, budget_bytes: int = 1 << 27):
        self.budget_bytes = budget_bytes
        self._pending: List[Tuple[tuple, object, int]] = []
        self._bytes = 0

    def submit(self, tensors) -> List[tuple]:
        tensors = tuple(tensors)
        event = None
        if tensors and tensors[0].is_cuda:
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         .copy_(t, non_blocking=True) for t in tensors)
            event = torch.cuda.Event()
            event.record()
        else:
            host = tuple(t.clone() for t in tensors)
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        self._pending.append((host, event, nbytes))
        self._bytes += nbytes
        done = []
        while len(self._pending) > 2 or (
                len(self._pending) > 1 and self._bytes > self.budget_bytes):
            done.append(self._pop())
        return done

    def _pop(self) -> tuple:
        host, event, nbytes = self._pending.pop(0)
        self._bytes -= nbytes
        if event is not None:
            event.synchronize()
        return host

    def drain(self) -> Iterator[tuple]:
        while self._pending:
            yield self._pop()


class SpillWriter:
    """Per-bin segment files and an atomic manifest under one directory.

    Two record kinds, each an npz with its CRC32 in the manifest:

    - 'pairs': {'keys', 'counts'}: decoded (k-mer, count) records (the
      k-mer transport's receive tiles, the store's export when the tier
      engages);
    - 'sk': {'words', 'lengths'}: packed super-k-mer slots in their wire
      format, decoded only at drain time.

    Writes buffer in host memory per (bin, kind) and flush one segment a
    group once `flush_bytes` gather (or at commit). A fresh writer owns its
    directory and wipes leftover segments of dead runs. Arrays are numpy:
    the caller converts words to uint32/uint64 first."""

    def __init__(self, root: str, n_bins: int, *, meta: Optional[dict] = None,
                 flush_bytes: int = 1 << 22,
                 fault: Optional[resilience.FaultPlan] = None,
                 fresh: bool = True):
        if n_bins < 1:
            raise ValueError(f"n_bins must be >= 1, got {n_bins}")
        self.root = root
        self.n_bins = n_bins
        self.meta = dict(meta or {})
        self.flush_bytes = flush_bytes
        self.fault = fault if fault is not None \
            and fault.site in ("spill_write", "bin_corrupt") else None
        self._segments: List[dict] = []   # committed (manifest) segments
        self._pending: List[dict] = []    # written, not yet committed
        self._buf: Dict[Tuple[int, str], List[dict]] = {}
        self._buf_bytes = 0
        self._seq = 0
        self._writes = 0                  # lifetime segment writes (faults)
        self._corrupted = False           # 'bin_corrupt' fires once
        os.makedirs(root, exist_ok=True)
        if fresh:
            self._wipe()

    # -- ingest ------------------------------------------------------------

    def add_pairs(self, bins: np.ndarray, keys: np.ndarray,
                  counts: np.ndarray) -> None:
        """Append decoded (k-mer, count) records grouped by bin id."""
        self._add(bins, "pairs", keys=np.asarray(keys),
                  counts=np.asarray(counts))

    def add_superkmers(self, bins: np.ndarray, words: np.ndarray,
                       lengths: np.ndarray) -> None:
        """Append packed super-k-mer slots (wire format) grouped by bin."""
        self._add(bins, "sk", words=np.asarray(words),
                  lengths=np.asarray(lengths))

    def _add(self, bins: np.ndarray, kind: str, **arrays) -> None:
        bins = np.asarray(bins)
        if bins.size == 0:
            return
        for b in np.unique(bins):
            m = bins == b
            group = {name: a[m] for name, a in arrays.items()}
            self._buf.setdefault((int(b), kind), []).append(group)
            self._buf_bytes += sum(a.nbytes for a in group.values())
        if self._buf_bytes >= self.flush_bytes:
            self._flush()

    def _flush(self) -> None:
        for (b, kind), groups in sorted(self._buf.items()):
            arrays = {name: np.concatenate([g[name] for g in groups])
                      for name in groups[0]}
            self._write_segment(b, kind, arrays)
        self._buf = {}
        self._buf_bytes = 0

    def _write_segment(self, b: int, kind: str, arrays: dict) -> None:
        name = f"bin{b:04d}_seq{self._seq:06d}_{kind}.npz"
        self._seq += 1
        bio = io.BytesIO()
        np.savez(bio, **arrays)
        payload = bio.getvalue()
        path = os.path.join(self.root, name)
        fault = self.fault
        if fault is not None and fault.site == "spill_write" \
                and self._writes == fault.fail_after:
            with open(path, "wb") as f:          # torn write: no rename, no
                f.write(payload[:max(1, len(payload) // 2)])  # manifest entry
            raise resilience.InjectedFault(
                f"injected spill_write fault: died mid-write of {name} "
                f"(after {self._writes} committed segment writes)")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._writes += 1
        n = int(next(iter(arrays.values())).shape[0])
        self._pending.append({
            "bin": int(b), "file": name, "kind": kind, "n": n,
            "bytes": len(payload), "crc": zlib.crc32(payload) & 0xFFFFFFFF})

    # -- batch lifecycle ---------------------------------------------------

    def begin_batch(self) -> None:
        """Drop leftovers of an aborted or killed attempt before a replay."""
        self.abort_batch()

    def abort_batch(self) -> None:
        """Discard everything since the last commit (buffers and files)."""
        for seg in self._pending:
            try:
                os.remove(os.path.join(self.root, seg["file"]))
            except OSError:
                pass
        self._pending = []
        self._buf = {}
        self._buf_bytes = 0

    def commit(self) -> None:
        """Seal the pending segments into the manifest (atomically)."""
        self._flush()
        if self._pending:
            self._segments.extend(self._pending)
            self._pending = []
        self._write_manifest()
        if self.fault is not None and self.fault.site == "bin_corrupt" \
                and not self._corrupted:
            if any(s["bin"] == self.fault.bin for s in self._segments):
                self.corrupt_bin(self.fault.bin)
                self._corrupted = True

    def corrupt_bin(self, b: int) -> None:
        """Flip 8 bytes mid-file in the last sealed segment of bin `b` (the
        'bin_corrupt' drill); the manifest keeps the old CRC, so the next
        `read_bin(b)` raises `SpillCorrupt`."""
        segs = [s for s in self._segments if s["bin"] == b]
        if not segs:
            raise ValueError(f"bin {b} has no committed segments to corrupt")
        path = os.path.join(self.root, segs[-1]["file"])
        with open(path, "r+b") as f:
            data = bytearray(f.read())
            mid = len(data) // 2
            for i in range(mid, min(mid + 8, len(data))):
                data[i] ^= 0xFF
            f.seek(0)
            f.write(data)

    # -- drain -------------------------------------------------------------

    def read_bin(self, b: int,
                 segments: Optional[List[dict]] = None
                 ) -> Iterator[Tuple[str, dict]]:
        """Yield (kind, numpy arrays) of every committed segment of bin `b`,
        checking size and CRC32 against the manifest (-> `SpillCorrupt`).

        `segments` pins the manifest view read from (an earlier
        `state()['segments']`) in place of the live list: the query tier
        reads its snapshot's view, so a later commit never leaks in."""
        for seg in (self._segments if segments is None else segments):
            if seg["bin"] != b:
                continue
            path = os.path.join(self.root, seg["file"])
            try:
                with open(path, "rb") as f:
                    payload = f.read()
            except OSError as e:
                raise SpillCorrupt(
                    f"bin {b} segment {seg['file']} unreadable: {e}",
                    b, seg["file"])
            if len(payload) != seg["bytes"] \
                    or (zlib.crc32(payload) & 0xFFFFFFFF) != seg["crc"]:
                raise SpillCorrupt(
                    f"bin {b} segment {seg['file']} failed its checksum "
                    f"({len(payload)} bytes vs manifest {seg['bytes']})",
                    b, seg["file"])
            with np.load(io.BytesIO(payload)) as z:
                yield seg["kind"], {name: z[name] for name in z.files}

    # -- durability --------------------------------------------------------

    def state(self) -> dict:
        """The JSON-serializable manifest (committed segments only); rides
        `KmerCounter.save()` and feeds `attach()` on restore."""
        return {"format": 1, "n_bins": self.n_bins, "seq": self._seq,
                "meta": self.meta, "segments": list(self._segments),
                "spilled_bytes": self.spilled_bytes}

    @classmethod
    def attach(cls, root: str, state: dict, *, flush_bytes: int = 1 << 22,
               fault: Optional[resilience.FaultPlan] = None) -> "SpillWriter":
        """A writer rebuilt from a checkpointed manifest; files on disk
        that the manifest does not list (torn or uncommitted leftovers of
        the run that died, or segments committed after the checkpoint)
        are deleted."""
        w = cls(root, int(state["n_bins"]), meta=state.get("meta"),
                flush_bytes=flush_bytes, fault=fault, fresh=False)
        w._segments = [dict(s) for s in state["segments"]]
        w._seq = int(state["seq"])
        listed = {s["file"] for s in w._segments}
        for name in os.listdir(root):
            if name == MANIFEST:
                continue
            if name not in listed and (name.endswith(".npz")
                                       or name.endswith(".tmp")):
                try:
                    os.remove(os.path.join(root, name))
                except OSError:
                    pass
        w._write_manifest()
        return w

    def _write_manifest(self) -> None:
        path = os.path.join(self.root, MANIFEST)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state(), f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _wipe(self) -> None:
        for name in os.listdir(self.root):
            if name == MANIFEST or name.endswith(".npz") \
                    or name.endswith(".tmp"):
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass

    # -- observability -----------------------------------------------------

    @property
    def spilled_bytes(self) -> int:
        """Total committed segment bytes (DAKCStats.spilled_bytes)."""
        return sum(s["bytes"] for s in self._segments)

    @property
    def spilled_bins(self) -> int:
        """Distinct bins holding committed data (DAKCStats.spilled_bins)."""
        return len({s["bin"] for s in self._segments})

    @property
    def n_segments(self) -> int:
        return len(self._segments)

    def bin_records(self, b: int) -> int:
        """Committed record count of bin `b` (slots for 'sk', pairs)."""
        return sum(s["n"] for s in self._segments if s["bin"] == b)
