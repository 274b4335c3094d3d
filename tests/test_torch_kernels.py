"""The port's kernels: plain versions against the JAX package, bit-equal,
and (on a card only) the CUDA kernels against the plain versions (the
flash attention kernels within stated tolerances; their plain versions
are held to the JAX package in tests/test_torch_flash.py).

The JAX partition and accumulate kernels run in interpret mode through
`repro.kernels.ops`; the insert is held to `ref.hash_insert_ref`, which is
what `ops.hash_insert` runs off the TPU. 64-bit words go through one x64
subprocess.
"""

import numpy as np
import pytest
import torch

from _torch_parity import run_jax
from repro_torch import words as W
from repro_torch.kernels import ops, ref

try:
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    # The machine with the card has no JAX; only the gpu-marked tests,
    # which compare kernels with their plain versions, run there.
    jnp = jops = jref = None

PLAN_FIELDS = ("positions", "totals", "starts")
SENT32 = 0xFFFFFFFF


def _sorted_runs(rng, n, n_distinct, sent, dtype, long_run=0):
    vals = rng.integers(0, 1 << 30, size=n_distinct).astype(dtype)
    keys = np.sort(rng.choice(vals, size=n))
    if long_run:
        keys[100:100 + long_run] = keys[100]
        keys = np.sort(keys)
    keys[n - n // 8:] = sent
    w = rng.integers(1, 6, size=n).astype(np.int32)
    return keys, w


# Insert cases: (capacity, batch size, distinct keys, every home slot at
# the last slot?) -- duplicates within a batch, a probe that wraps, a table
# that fills until it drops.
INSERT_CASES = {
    "duplicates": (64, 300, 30, False),
    "wraps": (37, 120, 30, True),
    "full": (16, 200, 40, False),
}


def _insert_case(name, sent, dtype, seed):
    cap, n, nd, wrap = INSERT_CASES[name]
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 30, size=nd).astype(dtype)
    keys = rng.choice(vals, size=(2, n))
    keys[:, ::11] = sent
    w = rng.integers(0, 4, size=(2, n)).astype(np.int32)
    slots = (np.full((2, n), cap - 1, np.int32) if wrap
             else (keys % cap).astype(np.int32))
    # A table that already holds a key, at that key's home slot: a table
    # the path builds keeps every key reachable from its home slot without
    # an empty slot between, which a parallel insert relies on.
    home = cap - 1 if wrap else int(vals[0] % cap)
    tk = np.full((2, cap), sent, dtype)
    tk[:, home] = vals[0]
    tc = np.zeros((2, cap), np.int32)
    tc[:, home] = 5
    return tk, tc, keys, w, slots


def _port_insert(tk, tc, keys, w, slots, sent):
    tk_t = W.to_torch_words(tk)[0].clone()
    tc_t = torch.from_numpy(tc.copy())
    dropped = torch.zeros((tk.shape[0],), dtype=torch.int32)
    ops.hash_insert(tk_t, tc_t, W.to_torch_words(keys)[0],
                    torch.from_numpy(w), torch.from_numpy(slots),
                    sentinel_val=sent, dropped=dropped)
    return tk_t, tc_t, dropped


# --- partition ----------------------------------------------------------------

@pytest.mark.parametrize("b", [2, 9, 257])
@pytest.mark.parametrize("n", [1000, 4096])
def test_partition_plan_matches_jax(b, n):
    ids = np.random.default_rng(b * 7919 + n).integers(
        0, b, size=(2, n), dtype=np.int32)
    t = torch.from_numpy(ids)
    got = ops.make_partition_plan(t, b)
    oracle = ref.partition_plan(t, b)
    for r in range(2):
        jp = jops.make_partition_plan(jnp.asarray(ids[r]), b)
        jr = jref.partition_plan_ref(jnp.asarray(ids[r]), b)
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(getattr(got, f)[r].numpy(),
                                          np.asarray(getattr(jp, f)))
            np.testing.assert_array_equal(getattr(oracle, f)[r].numpy(),
                                          np.asarray(getattr(jr, f)))


@pytest.mark.parametrize("b", [9, 257])
def test_bucket_hist_and_positions_match_jax_refs(b):
    ids = np.random.default_rng(b).integers(0, b, size=(2, 4096),
                                            dtype=np.int32)
    t = torch.from_numpy(ids)
    hist = ops.bucket_hist(t, b)
    base = (torch.cumsum(hist, 1) - hist).to(torch.int32)
    pos = ops.bucket_positions(t, base)
    for r in range(2):
        np.testing.assert_array_equal(
            hist[r].numpy(),
            np.asarray(jref.bucket_hist_ref(jnp.asarray(ids[r]), b, 1024)))
        np.testing.assert_array_equal(
            pos[r].numpy(),
            np.asarray(jref.bucket_positions_ref(
                jnp.asarray(ids[r]), jnp.asarray(base[r].numpy()), 1024)))


def test_partition_tile_slots_overflow():
    """The tile slot math at a capacity that overflows: kept entries are
    the first `capacity` of each bucket in stream order."""
    key = torch.tensor([[0, 1, 0, 2, 0, 1, 0]], dtype=torch.int32)
    valid = key < 2
    plan = ops.make_partition_plan(key, 3)
    dst, fill, ovf = plan.tile_slots(key, valid, 2)
    assert dst.tolist() == [[0, 2, 1, 4, 4, 3, 4]]
    assert fill.tolist() == [[2, 2]] and ovf.tolist() == [2]


# --- accumulate ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "long_run", "all_sentinel"])
def test_segment_accumulate_matches_jax_k13(case):
    rng = np.random.default_rng(3)
    keys, w = _sorted_runs(rng, 4096, 3 if case == "long_run" else 700,
                           SENT32, np.uint32,
                           long_run=2500 if case == "long_run" else 0)
    if case == "all_sentinel":
        keys[:] = SENT32
    got = ops.segment_accumulate(W.to_torch_words(keys[None])[0],
                                 torch.from_numpy(w[None]),
                                 sentinel_val=SENT32)
    want = jops.segment_accumulate(jnp.asarray(keys), jnp.asarray(w),
                                   sentinel_val=SENT32, tile=1024)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))


# --- insert -------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(INSERT_CASES))
def test_hash_insert_matches_ref_k13(name):
    """Slot layout and drop count equal the sequential JAX reference."""
    tk, tc, keys, w, slots = _insert_case(name, SENT32, np.uint32, 11)
    got_k, got_c, got_d = _port_insert(tk, tc, keys, w, slots, SENT32)
    for r in range(2):
        jk, jc, jd = jref.hash_insert_ref(
            jnp.asarray(tk[r]), jnp.asarray(tc[r]), jnp.asarray(keys[r]),
            jnp.asarray(w[r]), jnp.asarray(slots[r]), SENT32)
        np.testing.assert_array_equal(W.to_numpy_words(got_k[r], 32),
                                      np.asarray(jk))
        np.testing.assert_array_equal(got_c[r].numpy(), np.asarray(jc))
        assert int(got_d[r]) == int(jd)
    assert (int(got_d.sum()) > 0) == (name == "full")


# --- 64-bit words: JAX in an x64 subprocess ------------------------------------

def _inputs64():
    rng = np.random.default_rng(5)
    sent = np.iinfo(np.uint64).max
    keys, w = _sorted_runs(rng, 4096, 300, sent, np.uint64, long_run=1500)
    keys[:4000] |= np.uint64(1 << 61)
    keys[:4000] = np.sort(keys[:4000])
    out = {"acc_keys": keys, "acc_w": w}
    for name in INSERT_CASES:
        for part, a in zip(("tk", "tc", "keys", "w", "slots"),
                           _insert_case(name, sent, np.uint64, 13)):
            out[f"{name}_{part}"] = a
    return out


INPUTS64 = _inputs64()

_BODY64 = """
from repro.kernels import ops, ref
sent = int(np.iinfo(np.uint64).max)
O["acc"] = np.stack([np.asarray(x, np.int64) for x in ops.segment_accumulate(
    jnp.asarray(I["acc_keys"]), jnp.asarray(I["acc_w"]), sentinel_val=sent,
    tile=1024)])
for name in ("duplicates", "wraps", "full"):
    g = lambda p: I[f"{name}_{p}"]
    for r in range(2):
        tk, tc, d = ref.hash_insert_ref(
            jnp.asarray(g("tk")[r]), jnp.asarray(g("tc")[r]),
            jnp.asarray(g("keys")[r]), jnp.asarray(g("w")[r]),
            jnp.asarray(g("slots")[r]), sent)
        O[f"{name}_{r}_tk"], O[f"{name}_{r}_tc"], O[f"{name}_{r}_d"] = tk, tc, d
"""


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    return run_jax(tmp_path_factory.mktemp("kernels64"), _BODY64, INPUTS64,
                   x64=True)


def test_segment_accumulate_matches_jax_64bit(jax64):
    got = ops.segment_accumulate(
        W.to_torch_words(INPUTS64["acc_keys"][None])[0],
        torch.from_numpy(INPUTS64["acc_w"][None]), sentinel_val=-1)
    for g, r in zip(got, jax64["acc"]):
        np.testing.assert_array_equal(g[0].numpy().astype(np.int64), r)


@pytest.mark.parametrize("name", sorted(INSERT_CASES))
def test_hash_insert_matches_ref_64bit(jax64, name):
    args = [INPUTS64[f"{name}_{p}"] for p in ("tk", "tc", "keys", "w",
                                              "slots")]
    got_k, got_c, got_d = _port_insert(*args, -1)
    for r in range(2):
        np.testing.assert_array_equal(W.to_numpy_words(got_k[r], 64),
                                      jax64[f"{name}_{r}_tk"])
        np.testing.assert_array_equal(got_c[r].numpy(),
                                      jax64[f"{name}_{r}_tc"])
        assert int(got_d[r]) == int(jax64[f"{name}_{r}_d"])


# --- dispatch -------------------------------------------------------------------

def test_no_kernel_for_other_devices():
    """A tensor that is neither on the CPU, on a card nor on `meta` (the
    dry-run's trace) raises: there is no silent route to the plain
    version. A meta tensor gets the kernel's shapes and no launch, and
    rows 8-10, which no traced step reaches, raise on it."""
    from types import SimpleNamespace
    other = SimpleNamespace(device=SimpleNamespace(type="mps"))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops._route(other)
    ids = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    ops.reset_launches()
    hist = ops.bucket_hist(ids, 2)
    assert hist.device.type == "meta" and hist.shape == (1, 1, 2)
    assert set(ops.launch_counts().values()) == {0}
    words = torch.zeros((1, 8), dtype=torch.int64, device="meta")
    for call in (lambda: ops.radix_hist(words, 0, 4, 8),
                 lambda: ops.segment_boundaries(words, sentinel_val=-1),
                 lambda: ops.kmer_extract(ids.to(torch.uint8), 3)):
        with pytest.raises(ValueError, match="no meta path"):
            call()


def test_cpu_path_counts_no_launches():
    ops.reset_launches()
    ops.make_partition_plan(torch.zeros((1, 8), dtype=torch.int32), 2)
    assert set(ops.launch_counts().values()) == {0}


# --- on the card only ---------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `python3 chip_smoke.py` there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [2, 9, 257])
def test_partition_kernels_match_plain_on_card(b):
    dev = _cuda()
    ids = torch.randint(0, b, (8, 30720), dtype=torch.int32, device=dev)
    got = ops.make_partition_plan(ids, b)
    torch.cuda.synchronize()
    want = ref.partition_plan(ids, b)
    for f in PLAN_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [32, 64])
def test_segment_accumulate_kernel_matches_plain_on_card(bits):
    dev = _cuda()
    sent = W.sentinel(bits)
    keys, w = _sorted_runs(np.random.default_rng(bits), 300_000, 40,
                           np.uint32(SENT32) if bits == 32
                           else np.iinfo(np.uint64).max,
                           np.uint32 if bits == 32 else np.uint64,
                           long_run=150_000)
    kt = W.to_torch_words(keys[None])[0].to(dev)
    wt = torch.from_numpy(w[None]).to(dev)
    got = ops.segment_accumulate(kt, wt, sentinel_val=sent)
    torch.cuda.synchronize()
    for g, r in zip(got, ref.segment_accumulate(kt, wt, sent)):
        assert torch.equal(g, r)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(INSERT_CASES))
def test_hash_insert_kernel_matches_plain_on_card(name):
    dev = _cuda()
    tk, tc, keys, w, slots = _insert_case(name, SENT32, np.uint32, 17)
    pk, pc, pd = _port_insert(tk, tc, keys, w, slots, SENT32)
    dk = W.to_torch_words(tk)[0].to(dev)
    dc = torch.from_numpy(tc).to(dev)
    dd = torch.zeros((2,), dtype=torch.int32, device=dev)
    ops.hash_insert(dk, dc, W.to_torch_words(keys)[0].to(dev),
                    torch.from_numpy(w).to(dev),
                    torch.from_numpy(slots).to(dev), sentinel_val=SENT32,
                    dropped=dd)
    torch.cuda.synchronize()
    dk, dc, dd = dk.cpu(), dc.cpu(), dd.cpu()
    for r in range(2):
        assert (int(dd[r]) > 0) == (int(pd[r]) > 0)
        if int(pd[r]) == 0:
            occ, pocc = dk[r] != SENT32, pk[r] != SENT32
            assert sorted(zip(dk[r][occ].tolist(), dc[r][occ].tolist())) == \
                sorted(zip(pk[r][pocc].tolist(), pc[r][pocc].tolist()))


def _lookup_case(name, seed):
    """(table keys, counts, queries, home slots) of one lookup case, on
    the CPU: a table built by the plain insert, then probed with its own
    keys, keys it lacks, and sentinels."""
    cap, n_keys, wrap = {"sparse": (64, 30, False), "wraps": (37, 30, True),
                         "full": (16, 40, False)}[name]
    rng = np.random.default_rng(seed)
    keys = W.to_torch_words(rng.integers(0, 1 << 30, size=(2, n_keys))
                            .astype(np.uint32))[0]
    slot_of = ((lambda k: torch.full_like(k, cap - 1, dtype=torch.int32))
               if wrap else (lambda k: (k % cap).to(torch.int32)))
    tk = torch.full((2, cap), SENT32, dtype=torch.int64)
    tc = torch.zeros((2, cap), dtype=torch.int32)
    ops.hash_insert(tk, tc, keys, torch.ones_like(keys, dtype=torch.int32),
                    slot_of(keys), sentinel_val=SENT32,
                    dropped=torch.zeros((2,), dtype=torch.int32))
    miss = keys + (1 << 30)
    q = torch.cat([keys, miss, torch.full((2, 5), SENT32)], 1)
    return tk, tc, q, slot_of(q)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sparse", "wraps", "full"])
def test_hash_lookup_kernel_matches_plain_on_card(name):
    dev = _cuda()
    tk, tc, q, slots = _lookup_case(name, 23)
    ps = torch.zeros((2, 3), dtype=torch.int64)
    pc, pp = ops.hash_lookup(tk, tc, q, slots, sentinel_val=SENT32, stats=ps)
    ds = ps.to(dev).zero_()
    dc, dp = ops.hash_lookup(tk.to(dev), tc.to(dev), q.to(dev),
                             slots.to(dev), sentinel_val=SENT32, stats=ds)
    torch.cuda.synchronize()
    assert torch.equal(dc.cpu(), pc) and torch.equal(dp.cpu(), pp)
    assert torch.equal(ds.cpu(), ps)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1, 257, 1 << 20, 23_592_960])
@pytest.mark.parametrize("bits", [32, 64])
def test_hash_lookup_no_slots_kernel_matches_plain_on_card(bits, cap):
    """Row 5 with `slots=None` against its plain version on the card, with
    1, 2 and 4 queries a thread: counts, probes and stats bit-equal. The
    table is filled by the insert kernel from its own home slots (caps 1
    and 257 fill up, so misses sweep the table and walks wrap); the
    queries are stored keys, keys it lacks (64-bit: the top bit set on
    every other one) and sentinels, as scattered padding and as the query
    path's tiles, each a live prefix."""
    from repro_torch.kernels import hash_table

    dev = _cuda()
    sent = W.sentinel(bits)
    rng = np.random.default_rng(cap + bits)
    n_keys = min(cap + 40, 300_000)
    keys = W.to_torch_words(_lookup_words(rng, 2 * n_keys, bits)
                            .reshape(2, n_keys))[0].to(dev)
    tk = torch.full((2, cap), sent, dtype=torch.int64, device=dev)
    tc = torch.zeros((2, cap), dtype=torch.int32, device=dev)
    ops.hash_insert(tk, tc, keys, torch.ones_like(keys, dtype=torch.int32),
                    None, sentinel_val=sent,
                    dropped=torch.zeros((2,), dtype=torch.int32, device=dev),
                    word_bits=bits)
    n = 8 * 16384
    miss = W.to_torch_words(_lookup_words(rng, 2 * n, bits)
                            .reshape(2, n))[0].to(dev)
    pick = torch.from_numpy(rng.integers(0, n_keys, size=(2, n))).to(dev)
    q = torch.where(torch.from_numpy(rng.random((2, n)) < 0.5).to(dev),
                    keys.gather(1, pick), miss)
    scattered = q.clone()
    scattered[:, ::7] = sent
    live = (torch.arange(16384, device=dev).view(1, -1) <
            torch.tensor([5000, 0, 16384, 1, 700, 0, 12000, 9000],
                         device=dev).view(-1, 1)).reshape(1, n)
    tiled = torch.where(live, q, sent)
    for batch in (scattered, tiled):
        want = ref.hash_lookup(tk, tc, batch, ref.home_slots(batch, cap, bits),
                               sent)
        want_stats = ref.lookup_stats(*want)
        stats = torch.zeros((2, 3), dtype=torch.int64, device=dev)
        got = hash_table.hash_lookup_cuda(tk, tc, batch, None, sent, bits,
                                          stats)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(stats, want_stats)
        stats = torch.zeros((2, 3), dtype=torch.int64, device=dev)
        got = ops.hash_lookup(tk, tc, batch, None, sentinel_val=sent,
                              word_bits=bits, stats=stats)
        assert torch.equal(got[0], want[0]) and torch.equal(stats, want_stats)
    if cap <= 257:
        assert int(want[1].max()) == cap      # a miss swept the full table


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1, 7, 25, 144])
@pytest.mark.parametrize("bits", [32, 64])
def test_sliding_min_kernels_match_plain_on_card(window, bits):
    dev = _cuda()
    hi = 1 << 62 if bits == 64 else 1 << 32
    keys = torch.randint(0, hi, (1001, 144), dtype=torch.int64)
    if bits == 64:
        keys[:, ::3] |= -(1 << 63)          # top bit set: compared unsigned
    keys[::2] %= 5                          # ties
    vals = torch.randint(0, 1 << 40, (1001, 144), dtype=torch.int64)
    got = ops.sliding_min(keys.to(dev), window)
    gk, gv = ops.sliding_min_pair(keys.to(dev), vals.to(dev), window)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.sliding_min(keys, window))
    pk, pv = ref.sliding_min_pair(keys, vals, window)
    assert torch.equal(gk.cpu(), pk) and torch.equal(gv.cpu(), pv)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [15, 16, 64, 120, 128, 256])
def test_flash_kernels_match_plain_on_card(d, dtype):
    """Rows 11-13 against ref.flash_fwd / ref.flash_bwd: GQA 4/2 and 8/1
    by index, a window with a softcap, q_offsets (77 is not a multiple of
    a tile), lengths that are not multiples of a tile, and many tiles
    through the kernels' rings (seq 1000 causal, seq 2048 under a window
    of 300); head dim 15 takes no 16-byte copies. f32 within 1e-5 (o,
    lse) and 5e-5 (grads); bf16 within one bf16 step of each value plus
    1e-4 of the largest; one launch a row, an f32 one counted as the
    f32 kernels'. bf16 also within one bf16 step of each
    term whose factor (p, ds) both sides round (ref.flash_rounded_terms):
    nearly equal f32 values may round to neighbouring bf16 values."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(d)

    def held(got, want, tol, terms):
        g, w = got.float(), want.float()
        if dt == torch.bfloat16:
            bound = (2.0 ** -7 * (w.abs() + terms)
                     + 1e-4 * float(w.abs().max()))
            assert bool(((g - w).abs() <= bound).all())
        else:
            assert float((g - w).abs().max()) <= tol

    for hq, hkv, causal, window, softcap, q_offset, sq, skv in (
            (4, 2, True, None, None, 0, 150, 150),
            (4, 2, True, 40, 20.0, 30, 70, 100),
            (4, 2, False, None, None, 0, 50, 90),
            (2, 2, True, None, None, 0, 1000, 1000),
            (2, 2, True, 300, None, 0, 2048, 2048),
            (8, 1, True, None, None, 0, 300, 300),
            (4, 2, True, None, None, 77, 200, 277)):
        q, do = (torch.randn((2, hq, sq, d), generator=gen, device=dev)
                 .to(dt) for _ in range(2))
        k, v = (torch.randn((2, hkv, skv, d), generator=gen, device=dev)
                .to(dt) for _ in range(2))
        band = dict(causal=causal, window=window, softcap=softcap,
                    q_offset=q_offset, scale=d ** -0.5)
        ops.reset_launches()
        o = ops.flash_attention(q, k, v, **band)
        o2, lse = ops.flash_attention_fwd_lse(q, k, v, **band)
        torch.cuda.synchronize()
        wo, wlse = ref.flash_fwd(q, k, v, with_lse=True, **band)
        kq = k.repeat_interleave(hq // hkv, 1)
        vq = v.repeat_interleave(hq // hkv, 1)
        terms = ref.flash_rounded_terms(q, kq, vq, wo, wlse, do, **band)
        held(o, wo, 1e-5, terms[0])
        held(o2, wo, 1e-5, terms[0])
        assert float((lse - wlse).abs().max()) <= 1e-5
        got = ops.flash_attention_bwd(q, kq, vq, wo, wlse, do, **band)
        torch.cuda.synchronize()
        for g, w, t in zip(got, ref.flash_bwd(q, kq, vq, wo, wlse, do,
                                              **band), terms[1:]):
            held(g, w, 5e-5, t)
        f32 = int(dt == torch.float32)
        assert {k: n for k, n in ops.launch_counts().items()
                if k in ops.f32_launch_counts()} == {
            "flash_attention": 1, "flash_attention_fwd_lse": 1,
            "flash_attention_bwd": 1}
        assert ops.f32_launch_counts() == {
            "flash_attention": f32, "flash_attention_fwd_lse": f32,
            "flash_attention_bwd": f32}


@pytest.mark.gpu
@pytest.mark.parametrize("k,bits,canonical,shape", [
    (1, 2, False, (1001, 150)), (1, 2, True, (1001, 150)),
    (13, 2, True, (1001, 150)), (15, 2, False, (64, 151)),
    (21, 2, True, (1001, 150)), (31, 2, False, (1001, 150)),
    (31, 2, True, (3, 9000)), (10, 3, False, (1001, 150)),
    (7, 8, False, (100, 64)), (62, 1, False, (40, 300)),
    (31, 2, True, (40, 31)), (29, 2, True, (70, 150)),
    (15, 2, True, (300, 60)), (31, 2, True, (3, 4201)),
    (21, 2, False, (2, 9001)), (20, 3, False, (7, 100)),
    (12, 5, False, (7, 77)), (10, 6, False, (7, 100)),
    (8, 7, False, (7, 100)), (15, 4, False, (9, 333)),
    (31, 2, True, (3, 8223)), (7, 8, False, (2, 20000))])
@pytest.mark.parametrize("offset", [0, 5])
def test_kmer_extract_kernel_matches_plain_on_card(k, bits, canonical, shape,
                                                   offset):
    """Row 9's packed-row kernel against the shift-or pack (and the
    reverse-complement sweep): odd k, k * bits = 62, m = k, odd n_pos,
    rows that span several tiles (n_pos > 8192, an odd row length), every
    bits 1-8, and codes that start `offset` bytes past a 16-byte
    boundary."""
    dev = _cuda()
    reads = torch.from_numpy(np.random.default_rng(k).integers(
        0, 1 << bits, size=shape, dtype=np.uint8))
    buf = torch.zeros((reads.numel() + offset,), dtype=torch.uint8,
                      device=dev)
    dreads = buf[offset:].view(shape)
    dreads.copy_(reads)
    got = ops.kmer_extract(dreads, k, bits, canonical=canonical)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ops.kmer_extract(reads, k, bits,
                                                   canonical=canonical))


@pytest.mark.gpu
@pytest.mark.parametrize("digit_bits,shift", [(2, 0), (4, 24), (8, 60),
                                              (12, 20), (4, 64), (1, 63)])
@pytest.mark.parametrize("bits", [32, 64])
def test_radix_hist_kernel_matches_plain_on_card(bits, digit_bits, shift):
    """Row 10 on words with the sentinel and (64-bit) the top bit set; a
    8192-key tile spans several blocks."""
    dev = _cuda()
    rng = np.random.default_rng(digit_bits * 100 + shift)
    if bits == 64:
        keys = rng.integers(0, 1 << 63, size=(3, 16384), dtype=np.uint64)
        keys[:, ::3] |= np.uint64(1 << 63)
        keys[:, ::7] = np.iinfo(np.uint64).max
    else:
        keys = rng.integers(0, 1 << 32, size=(3, 16384)).astype(np.uint32)
        keys[:, ::7] = SENT32
    kt = W.to_torch_words(keys)[0]
    for tile in (512, 1024, 8192):
        got = ops.radix_hist(kt.to(dev), shift, digit_bits, tile)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ops.radix_hist(kt, shift, digit_bits,
                                                     tile))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [32, 64])
def test_segment_boundaries_kernel_matches_plain_on_card(bits):
    """Row 8: runs that span blocks, sentinel padding, and a row that is
    all sentinel."""
    dev = _cuda()
    sent = W.sentinel(bits)
    keys, _ = _sorted_runs(np.random.default_rng(bits), 300_000, 40,
                           np.uint32(SENT32) if bits == 32
                           else np.iinfo(np.uint64).max,
                           np.uint32 if bits == 32 else np.uint64,
                           long_run=150_000)
    kt = W.to_torch_words(np.stack([keys, keys]))[0]
    kt[1] = sent
    got = ops.segment_boundaries(kt.to(dev), sentinel_val=sent)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ops.segment_boundaries(kt,
                                                         sentinel_val=sent))
    assert not bool(got[1].any())


def test_hash_lookup_plain_matches_jax_ref():
    for name in ("sparse", "wraps", "full"):
        tk, tc, q, slots = _lookup_case(name, 29)
        counts, probes = ops.hash_lookup(tk, tc, q, slots,
                                         sentinel_val=SENT32)
        for r in range(2):
            jc, jp = jref.hash_lookup_ref(
                jnp.asarray(W.to_numpy_words(tk[r], 32)),
                jnp.asarray(tc[r].numpy()),
                jnp.asarray(W.to_numpy_words(q[r], 32)),
                jnp.asarray(slots[r].numpy()), SENT32)
            np.testing.assert_array_equal(counts[r].numpy(), np.asarray(jc))
            np.testing.assert_array_equal(probes[r].numpy(), np.asarray(jp))
        if name == "full":
            assert int(probes.max()) == 16   # a miss sweeps the whole table


# --- row 5 with home slots hashed (`slots=None`) and the batch's stats -------

def _lookup_words(rng, n, bits):
    """n random words: 32-bit below the sentinel, 64-bit with the top bit
    set on every other one."""
    if bits == 32:
        return rng.integers(0, SENT32, size=n).astype(np.uint32)
    w = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
    w[::2] |= np.uint64(1 << 63)
    return w


def _hashed_lookup_case(name, bits, seed):
    """(table keys, counts, queries) of a lookup case on the CPU, the table
    built by the plain insert from hashed home slots: 'sparse' (hits,
    misses, sentinels), 'wraps' (every key's home slot one of the last
    two, so walks cross the end) and 'full' (every slot taken: a miss
    sweeps the table)."""
    cap, n_keys = {"sparse": (64, 30), "wraps": (37, 12), "full": (16, 40)}[
        name]
    rng = np.random.default_rng(seed)
    sent = W.sentinel(bits)
    if name == "wraps":
        cand = W.to_torch_words(_lookup_words(rng, 4000, bits))[0]
        cand = cand[ref.home_slots(cand, cap, bits) >= cap - 2]
        keys, miss = cand[:2 * n_keys].view(2, n_keys), cand[2 * n_keys:][:10]
        miss = miss.expand(2, -1)
    else:
        keys = W.to_torch_words(_lookup_words(rng, 2 * n_keys, bits)
                                .reshape(2, n_keys))[0]
        miss = W.to_torch_words(_lookup_words(rng, 20, bits)
                                .reshape(2, 10))[0]
    tk = torch.full((2, cap), sent, dtype=torch.int64)
    tc = torch.zeros((2, cap), dtype=torch.int32)
    ops.hash_insert(tk, tc, keys, torch.ones_like(keys, dtype=torch.int32),
                    None, sentinel_val=sent,
                    dropped=torch.zeros((2,), dtype=torch.int32),
                    word_bits=bits)
    q = torch.cat([keys, miss, torch.full((2, 5), sent)], 1)
    return tk, tc, q


HASHED_LOOKUP_CASES = [(b, n) for b in (32, 64)
                       for n in ("sparse", "wraps", "full")]


@pytest.mark.parametrize("bits,name", HASHED_LOOKUP_CASES)
def test_hash_lookup_no_slots_equals_home_slots(bits, name):
    """`slots=None` on the CPU probes exactly as explicit `ref.home_slots`;
    the cases reach a wrap and a sweep of a full table."""
    tk, tc, q = _hashed_lookup_case(name, bits, 31 + bits)
    cap, sent = tk.shape[1], W.sentinel(bits)
    got = ops.hash_lookup(tk, tc, q, None, sentinel_val=sent, word_bits=bits)
    want = ops.hash_lookup(tk, tc, q, ref.home_slots(q, cap, bits),
                           sentinel_val=sent)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    counts, probes = got
    if name == "full":
        assert int(probes.max()) == cap
    if name == "wraps":
        home = ref.home_slots(q, cap, bits).to(torch.int64)
        assert bool(((home + probes > cap) & (counts > 0)).any())
    assert int((counts > 0).sum()) > 0


def test_hash_lookup_no_slots_needs_word_bits():
    tk, tc, q = _hashed_lookup_case("sparse", 32, 1)
    with pytest.raises(ValueError, match="word_bits"):
        ops.hash_lookup(tk, tc, q, None, sentinel_val=SENT32)


@pytest.mark.parametrize("bits,name", HASHED_LOOKUP_CASES)
def test_hash_lookup_stats_sum_its_outputs(bits, name):
    """`stats` gets each row's hits, probe sum and longest walk, counted
    here in numpy from the returned arrays; a second call adds the sums
    and keeps the maximum."""
    tk, tc, q = _hashed_lookup_case(name, bits, 37 + bits)
    sent = W.sentinel(bits)
    stats = torch.zeros((2, 3), dtype=torch.int64)
    counts, probes = ops.hash_lookup(tk, tc, q, None, sentinel_val=sent,
                                     word_bits=bits, stats=stats)
    c, p = counts.numpy(), probes.numpy().astype(np.int64)
    want = np.stack([(c > 0).sum(1), p.sum(1), p.max(1)], 1)
    np.testing.assert_array_equal(stats.numpy(), want)
    assert stats.dtype == torch.int64
    ops.hash_lookup(tk, tc, q, None, sentinel_val=sent, word_bits=bits,
                    stats=stats)
    np.testing.assert_array_equal(stats[:, :2].numpy(), 2 * want[:, :2])
    np.testing.assert_array_equal(stats[:, 2].numpy(), want[:, 2])


@pytest.mark.parametrize("bits", [32, 64])
def test_hash_lookup_stats_zero_for_padding(bits):
    """A batch of sentinels (and an empty batch) reads nothing: counts and
    probes 0, stats 0."""
    tk, tc, _ = _hashed_lookup_case("full", bits, 3)
    sent = W.sentinel(bits)
    for n in (0, 700):
        q = torch.full((2, n), sent, dtype=torch.int64)
        stats = torch.zeros((2, 3), dtype=torch.int64)
        counts, probes = ops.hash_lookup(tk, tc, q, None, sentinel_val=sent,
                                         word_bits=bits, stats=stats)
        assert not bool(counts.any()) and not bool(probes.any())
        assert not bool(stats.any())


@pytest.mark.parametrize("name", ["sparse", "wraps", "full"])
def test_hash_lookup_no_slots_matches_jax_k13(name):
    """The hashed lookup against the JAX package's `hash_lookup_ref` from
    its own `store_slots` (32-bit words)."""
    from repro.core import countstore as jcs
    tk, tc, q = _hashed_lookup_case(name, 32, 41)
    cap = tk.shape[1]
    counts, probes = ops.hash_lookup(tk, tc, q, None, sentinel_val=SENT32,
                                     word_bits=32)
    for r in range(2):
        jq = jnp.asarray(W.to_numpy_words(q[r], 32))
        jc, jp = jref.hash_lookup_ref(
            jnp.asarray(W.to_numpy_words(tk[r], 32)),
            jnp.asarray(tc[r].numpy()), jq, jcs.store_slots(jq, cap), SENT32)
        np.testing.assert_array_equal(counts[r].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(probes[r].numpy(), np.asarray(jp))


# --- the kernels' block layouts, mirrored on the CPU --------------------------
# The CUDA kernels run only on a card. These mirrors walk the blocks of
# `csrc/minimizer.cu`'s sliding_min_kernel and `csrc/radix_partition.cu`'s
# bucket_positions_kernel in numpy, with the layouts the wrappers pick, and
# hold them to the plain versions: a fault in the block decomposition or
# the rank arithmetic shows here before a card runs it.

def _mirror_sliding_min(vals: np.ndarray, window: int):
    """sliding_min_kernel's blocks over (rows, n_pos) uint64 words: returns
    the outputs and how often each was written."""
    from repro_torch.kernels import minimizer

    rows, n_pos = vals.shape
    n_out = n_pos - window + 1
    seg_rows, tp = minimizer._plain_layout(n_pos, window)
    flat_in = vals.reshape(-1)
    out = np.zeros(rows * n_out, np.uint64)
    writes = np.zeros(rows * n_out, np.int64)
    tiles = -(-n_out // tp) if tp else 0
    blocks = -(-rows // seg_rows) if tp == 0 else rows * tiles
    for blk in range(blocks):
        if tp == 0:
            r0 = blk * seg_rows
            nseg, seg_len, q = min(seg_rows, rows - r0), n_pos, n_out
            first, out0 = r0 * n_pos, r0 * n_out
        else:
            row, p0 = divmod(blk, tiles)
            p0 *= tp
            nseg, q = 1, min(tp, n_out - p0)
            seg_len = q + window - 1
            first, out0 = row * n_pos + p0, row * n_out + p0
        span = nseg * seg_len
        staged = 2 * span + 2 if n_out > 1 else span + 2
        assert staged * 8 <= 227 * 1024
        if tp == 0:
            assert staged * 8 <= 48 * 1024
        x = flat_in[first:first + span].reshape(nseg, seg_len)
        if q == 1:
            got = x.min(1)
        else:
            g = np.empty_like(x)
            h = np.empty_like(x)
            for lo in range(0, seg_len, window):
                hi = min(seg_len, lo + window)
                g[:, lo:hi] = np.minimum.accumulate(x[:, lo:hi], 1)
                h[:, lo:hi] = np.minimum.accumulate(
                    x[:, lo:hi][:, ::-1], 1)[:, ::-1]
            got = np.minimum(h[:, :q], g[:, window - 1:window - 1 + q])
        out[out0:out0 + nseg * q] = got.reshape(-1)
        writes[out0:out0 + nseg * q] += 1
    return out.reshape(rows, n_out), writes


@pytest.mark.parametrize("rows,n_pos,window", [
    (7, 30, 1), (7, 30, 7), (7, 30, 30), (300, 25, 25), (1001, 144, 25),
    (5, 2048, 2048), (3, 2049, 25), (2, 5000, 1), (2, 5000, 3000),
    (2, 5000, 5000), (1, 20000, 14000)])
def test_sliding_min_block_layout_mirror(rows, n_pos, window):
    """Every output written once, equal to the plain version: whole-row
    blocks, the one-window reduction, and position tiles of long rows."""
    rng = np.random.default_rng(rows * n_pos + window)
    vals = rng.integers(0, 1 << 63, size=(rows, n_pos), dtype=np.uint64)
    vals[::3] |= np.uint64(1 << 63)
    vals[1::4] %= np.uint64(3)
    got, writes = _mirror_sliding_min(vals, window)
    assert (writes == 1).all()
    want = ref.sliding_min(W.to_torch_words(vals)[0], window)
    np.testing.assert_array_equal(got, W.to_numpy_words(want, 64))


def test_sliding_min_layout_refuses_too_wide_window():
    from repro_torch.kernels import minimizer

    with pytest.raises(ValueError, match="too wide"):
        minimizer._plain_layout(40000, 20000)


def _mirror_bucket_positions(ids: np.ndarray, base: np.ndarray):
    """bucket_positions_kernel's ranks: 8 warps of 128 elements a tile, 4
    ordered passes of 32 lanes, a running count per (warp, bucket), an
    exclusive scan over the warps from the tile's base. -1 where an id is
    outside [0, B) (the kernel writes nothing there)."""
    from repro_torch.kernels.radix_partition import MAX_BUCKETS

    rows, n = ids.shape
    b_count = base.shape[2]
    assert b_count <= MAX_BUCKETS and 9 * b_count * 4 + 4096 <= 48 * 1024
    pos = np.full((rows, n), -1, np.int64)
    for r in range(rows):
        for t in range(-(-n // 1024)):
            tile = np.full(1024, -1, np.int64)
            piece = ids[r, t * 1024:(t + 1) * 1024]
            tile[:piece.size] = piece
            table = np.zeros((8, b_count), np.int64)
            bucket = np.full((8, 4, 32), -1, np.int64)
            rank = np.zeros((8, 4, 32), np.int64)
            for w in range(8):
                for p in range(4):
                    lanes = tile[w * 128 + p * 32:w * 128 + p * 32 + 32]
                    for lane, b in enumerate(lanes):
                        if 0 <= b < b_count:
                            lower = int((lanes[:lane] == b).sum())
                            bucket[w, p, lane] = b
                            rank[w, p, lane] = table[w, b] + lower
                    for b in set(int(v) for v in lanes if 0 <= v < b_count):
                        table[w, b] += int((lanes == b).sum())
            first = np.cumsum(table, 0) - table + base[r, t][None, :]
            for w in range(8):
                for p in range(4):
                    for lane in range(32):
                        e = t * 1024 + w * 128 + p * 32 + lane
                        b = bucket[w, p, lane]
                        if e < n and b >= 0:
                            pos[r, e] = first[w, b] + rank[w, p, lane]
    return pos


def _positions_want(ids: torch.Tensor, base: torch.Tensor):
    """ref.bucket_positions with every id outside [0, B) moved to a bucket
    B of its own, and the mask of the valid ids: a valid id's slot does not
    depend on the others."""
    b_count = base.shape[2]
    valid = (ids >= 0) & (ids < b_count)
    base1 = torch.cat([base, torch.zeros_like(base[..., :1])], 2)
    want = ref.bucket_positions(torch.where(valid, ids, b_count), base1,
                                ops.TILE)
    return want, valid


def _positions_case(kind: str, rows: int, n: int, b_count: int, seed: int):
    """(ids, base) of a rank case: random ids, ids of -1 and B among them,
    a single bucket, or two alternating buckets; any int32 base."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, b_count, size=(rows, n)).astype(np.int32)
    if kind == "invalid":
        ids[:, ::5] = -1
        ids[:, 2::7] = b_count
    elif kind == "one bucket":
        ids[:] = b_count // 2
    elif kind == "alternating":
        ids[:] = np.where(np.arange(n) % 2 == 0, 0, b_count - 1)
    n_tiles = -(-n // ops.TILE)
    base = rng.integers(0, 1 << 24, size=(rows, n_tiles, b_count)).astype(
        np.int32)
    return torch.from_numpy(ids), torch.from_numpy(base)


POSITION_CASES = [
    ("random", 2, 3001, 2), ("random", 2, 3001, 9), ("random", 2, 2048, 257),
    ("random", 1, 4096, 1024), ("invalid", 2, 3001, 9),
    ("one bucket", 2, 2050, 257), ("alternating", 2, 2050, 257)]


@pytest.mark.parametrize("kind,rows,n,b_count", POSITION_CASES)
def test_bucket_positions_rank_mirror(kind, rows, n, b_count):
    ids, base = _positions_case(kind, rows, n, b_count, 3)
    got = _mirror_bucket_positions(ids.numpy(), base.numpy())
    want, valid = _positions_want(ids, base)
    np.testing.assert_array_equal(got[valid.numpy()],
                                  want[valid].numpy())
    assert (got[~valid.numpy()] == -1).all()


def test_load_declares_entry_points_once(monkeypatch):
    """`build.load` declares a library's argtypes at its first call and
    hands back the same library afterwards without declaring them again."""
    import ctypes
    from types import SimpleNamespace

    from repro_torch.kernels import build

    lib = SimpleNamespace(f=SimpleNamespace())
    monkeypatch.setitem(build._LIBS, "fake", lib)
    monkeypatch.setattr(build, "_BOUND", {})
    assert build.load("fake", {"f": (ctypes.c_void_p,)}) is lib
    assert lib.f.argtypes == [ctypes.c_void_p]
    assert lib.f.restype is ctypes.c_int
    lib.f.argtypes = "kept"
    assert build.load("fake", {"f": (ctypes.c_void_p,)}) is lib
    assert lib.f.argtypes == "kept"


# --- rows 2 and 6 on the card -------------------------------------------------

SLIDING_MIN_CASES = [
    # (rows, n_pos, window, kind): w = 1 and w = n_pos; n_pos not a
    # multiple of w; 1001 rows; the query path's shape; rows where every
    # key ties; long rows in position tiles; a view that starts 8 bytes
    # into a 16-byte unit.
    (1001, 144, 1, "random"), (1001, 144, 144, "random"),
    (1001, 144, 25, "random"), (1001, 131, 12, "random"),
    (1 << 20, 25, 25, "random"), (1001, 144, 25, "ties"),
    (3, 5000, 25, "random"), (3, 5000, 3000, "random"),
    (1001, 25, 25, "offset"), (1001, 144, 25, "offset")]


def _sliding_min_input(rows, n_pos, kind, seed):
    """Random 64-bit words, the top bit set on every third row (compared
    unsigned); 'ties' makes every other row constant (poly-A)."""
    g = torch.Generator().manual_seed(seed)
    vals = torch.randint(0, 1 << 62, (rows, n_pos), generator=g)
    vals[::3] |= -(1 << 63)
    if kind == "ties":
        vals[::2] = vals[::2, :1]
    return vals


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n_pos,window,kind", SLIDING_MIN_CASES)
def test_sliding_min_plain_kernel_matches_plain_on_card(rows, n_pos, window,
                                                        kind):
    """Row 6's van Herk / Gil-Werman kernel, bit-equal."""
    dev = _cuda()
    vals = _sliding_min_input(rows, n_pos, kind, rows + window)
    if kind == "offset":   # one word into a 16-byte aligned buffer
        buf = torch.zeros((rows * n_pos + 1,), dtype=torch.int64, device=dev)
        dvals = buf[1:].view(rows, n_pos)
        dvals.copy_(vals)
        assert dvals.data_ptr() % 16 == 8
    else:
        dvals = vals.to(dev)
    got = ops.sliding_min(dvals, window)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.sliding_min(vals, window))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,rows,n,b_count", POSITION_CASES + [
    ("random", 8, 30720, 257), ("invalid", 3, 5000, 257),
    ("one bucket", 1, 4096, 2), ("alternating", 3, 3001, 9)])
def test_bucket_positions_kernel_matches_plain_on_card(kind, rows, n,
                                                       b_count):
    """Row 2's 8-warp rank kernel, bit-equal on every valid id: B up to
    MAX_BUCKETS, ragged tiles, rows that start mid-way into 16 bytes, ids
    of -1 and B, one bucket, alternating buckets."""
    dev = _cuda()
    ids, base = _positions_case(kind, rows, n, b_count, rows * n + b_count)
    got = ops.bucket_positions(ids.to(dev), base.to(dev))
    torch.cuda.synchronize()
    want, valid = _positions_want(ids, base)
    assert torch.equal(got.cpu()[valid], want[valid])


# --- row 4: home slots computed in the insert kernel ------------------------
# With no slots, `csrc/hash_table.cu` hashes each key itself: the slot hash
# in unsigned 32- or 64-bit arithmetic, then the unsigned `%` by the
# capacity. The mirror below does exactly that in numpy integers.

_C64 = (np.uint64(0xBF58476D1CE4E5B9), np.uint64(0x94D049BB133111EB))


def _mirror_mix64(x):
    x = x ^ (x >> np.uint64(30))
    x = x * _C64[0]
    x = x ^ (x >> np.uint64(27))
    x = x * _C64[1]
    return x ^ (x >> np.uint64(31))


def _mirror_mix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def _mirror_umulhi64(a, b):
    """CUDA's __umul64hi on uint64 arrays, from 32-bit halves."""
    m32 = np.uint64(0xFFFFFFFF)
    s32 = np.uint64(32)
    a_lo, a_hi, b_lo, b_hi = a & m32, a >> s32, b & m32, b >> s32
    hi_lo, lo_hi = a_hi * b_lo, a_lo * b_hi
    cross = ((a_lo * b_lo) >> s32) + (hi_lo & m32) + (lo_hi & m32)
    return a_hi * b_hi + (hi_lo >> s32) + (lo_hi >> s32) + (cross >> s32)


def _mirror_home_slots(words: np.ndarray, cap: int, word_bits: int):
    """The kernels' home_slot over uint32/uint64 words: the slot hash, then
    the remainder from the host's inverse m = (2**64 - 1) // cap, one
    multiply-high and one correction."""
    if word_bits == 64:
        h = _mirror_mix64(_mirror_mix64(words.astype(np.uint64))
                          ^ np.uint64(0x9E3779B97F4A7C15))
    else:
        h = _mirror_mix32(_mirror_mix32(words.astype(np.uint32))
                          ^ np.uint32(0x9E3779B9)).astype(np.uint64)
    c = np.uint64(cap)
    r = h - _mirror_umulhi64(h, np.uint64(((1 << 64) - 1) // cap)) * c
    assert (r < 2 * c).all()
    return np.where(r >= c, r - c, r).astype(np.int32)


HOME_CAPS = (1, 2, (1 << 31) - 1, 188_743_680)


def _home_words():
    rng = np.random.default_rng(17)
    w64 = rng.integers(0, 1 << 63, size=100_000, dtype=np.uint64)
    w64[::2] |= np.uint64(1 << 63)           # the top bit set
    w64[:4] = [0, 1, (1 << 64) - 2, (1 << 64) - 1]
    w32 = rng.integers(0, 1 << 32, size=100_000).astype(np.uint32)
    return w64, w32


HOME64, HOME32 = _home_words()

def _store_batch(bits):
    """Words of a k=13 (32-bit) or k=31 (64-bit) batch with repeats and
    sentinel padding, and their counts."""
    rng = np.random.default_rng(bits)
    dt = np.uint32 if bits == 32 else np.uint64
    pool = rng.integers(0, 1 << (26 if bits == 32 else 62), size=400,
                        dtype=np.uint64)
    words = rng.choice(pool, size=(1, 1500)).astype(dt)
    words[:, ::9] = np.iinfo(dt).max
    return words, rng.integers(0, 4, size=(1, 1500)).astype(np.int32)


STORE64 = _store_batch(64)


def _store_queries(words, bits):
    """Lookup queries of a store batch: its own words (sentinels among
    them), 300 words it lacks and 5 sentinels."""
    rng = np.random.default_rng(bits + 1)
    dt = np.uint32 if bits == 32 else np.uint64
    miss = rng.integers(0, 1 << (26 if bits == 32 else 62), size=300,
                        dtype=np.uint64).astype(dt)
    return np.concatenate([words[0], miss, np.full(5, np.iinfo(dt).max, dt)])


LOOKUP64 = _store_queries(STORE64[0], 64)

_BODY_HOME = """
from repro.core import countstore
for cap in (1, 2, (1 << 31) - 1, 188_743_680):
    O[f"s64_{cap}"] = countstore.store_slots(jnp.asarray(I["w64"]), cap)
for cap in (1801, 300):
    s = countstore.store_insert(countstore.empty_store(cap, jnp.uint64),
                                jnp.asarray(I["sw"][0]),
                                jnp.asarray(I["sc"][0]))
    O[f"st_{cap}"] = np.stack([np.asarray(s.keys).view(np.int64),
                               np.asarray(s.counts).astype(np.int64)])
    O[f"sd_{cap}"] = s.dropped
    c, p = countstore.store_lookup(s, jnp.asarray(I["lq"]))
    O[f"lk_{cap}"] = np.stack([np.asarray(c), np.asarray(p)])
"""


@pytest.fixture(scope="module")
def jax_home64(tmp_path_factory):
    return run_jax(tmp_path_factory.mktemp("home64"), _BODY_HOME,
                   {"w64": HOME64, "sw": STORE64[0], "sc": STORE64[1],
                    "lq": LOOKUP64},
                   x64=True)


@pytest.mark.parametrize("cap", HOME_CAPS)
def test_home_slot_mirror_64bit(jax_home64, cap):
    """10**5 64-bit words, half with the top bit set: the kernel's unsigned
    remainder equals `words.umod` of the port's slot hash, `ref.home_slots`
    and the JAX package's `store_slots`."""
    got = _mirror_home_slots(HOME64, cap, 64)
    t = W.to_torch_words(HOME64)[0]
    from repro_torch.core import owner
    np.testing.assert_array_equal(
        got, W.umod(owner.slot_hash(t, 64), cap, 64).to(torch.int32).numpy())
    np.testing.assert_array_equal(got, ref.home_slots(t, cap, 64).numpy())
    np.testing.assert_array_equal(got, jax_home64[f"s64_{cap}"])


@pytest.mark.parametrize("cap", HOME_CAPS)
def test_home_slot_mirror_32bit(cap):
    from repro.core import countstore as jcs
    got = _mirror_home_slots(HOME32, cap, 32)
    t = W.to_torch_words(HOME32)[0]
    np.testing.assert_array_equal(got, ref.home_slots(t, cap, 32).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jcs.store_slots(jnp.asarray(HOME32), cap)))


def _port_store_insert(words, counts, cap, bits):
    from repro_torch.core import countstore
    st = countstore.empty_store(1, cap, bits)
    return countstore.store_insert(st, W.to_torch_words(words)[0],
                                   torch.from_numpy(counts))


@pytest.mark.parametrize("cap", [1801, 300])
def test_store_insert_no_slots_matches_jax_k31(jax_home64, cap):
    """`store_insert` passes no slots; on the CPU its layout, counts and
    drops equal the JAX package's store at k=31 (300 slots: it drops)."""
    st = _port_store_insert(*STORE64, cap, 64)
    want = jax_home64[f"st_{cap}"]
    np.testing.assert_array_equal(st.keys[0].numpy(), want[0])
    np.testing.assert_array_equal(st.counts[0].numpy(), want[1])
    assert int(st.dropped[0]) == int(jax_home64[f"sd_{cap}"])
    assert (int(st.dropped[0]) > 0) == (cap == 300)


@pytest.mark.parametrize("cap", [1801, 300])
def test_store_lookup_matches_jax_k31(jax_home64, cap):
    """`store_lookup` passes no slots; on the CPU its counts and probe
    lengths equal the JAX package's `store_lookup` at k=31 (300 slots: the
    store dropped, so some of its own words miss), and its stats those of
    the JAX outputs."""
    from repro_torch.core import countstore
    st = _port_store_insert(*STORE64, cap, 64)
    stats = torch.zeros((1, 3), dtype=torch.int64)
    counts, probes = countstore.store_lookup(
        st, W.to_torch_words(LOOKUP64[None])[0], stats)
    want = jax_home64[f"lk_{cap}"]
    np.testing.assert_array_equal(counts[0].numpy(), want[0])
    np.testing.assert_array_equal(probes[0].numpy(), want[1])
    np.testing.assert_array_equal(
        stats[0].numpy(), [(want[0] > 0).sum(), want[1].astype(np.int64).sum(),
                           want[1].max()])
    if cap == 300:
        assert int(st.dropped[0]) > 0
        live = LOOKUP64[:1500] != np.iinfo(np.uint64).max
        assert ((want[0][:1500] == 0) & live).any()


@pytest.mark.parametrize("cap", [1801, 300])
def test_store_insert_no_slots_matches_jax_k13(cap):
    from repro.core import countstore as jcs
    words, counts = _store_batch(32)
    st = _port_store_insert(words, counts, cap, 32)
    js = jcs.store_insert(jcs.empty_store(cap, jnp.uint32),
                          jnp.asarray(words[0]), jnp.asarray(counts[0]))
    np.testing.assert_array_equal(W.to_numpy_words(st.keys[0], 32),
                                  np.asarray(js.keys))
    np.testing.assert_array_equal(st.counts[0].numpy(),
                                  np.asarray(js.counts))
    assert int(st.dropped[0]) == int(js.dropped)
    assert (int(st.dropped[0]) > 0) == (cap == 300)


@pytest.mark.parametrize("name", sorted(INSERT_CASES))
def test_hash_insert_no_slots_equals_home_slots(name):
    """`slots=None` on the CPU folds exactly as explicit `ref.home_slots`."""
    tk, tc, keys, w, _ = _insert_case(name, SENT32, np.uint32, 19)
    cap = tk.shape[1]
    slots = ref.home_slots(W.to_torch_words(keys)[0], cap, 32).numpy()
    want = _port_insert(tk, tc, keys, w, slots, SENT32)
    got_k = W.to_torch_words(tk)[0].clone()
    got_c = torch.from_numpy(tc.copy())
    got_d = torch.zeros((2,), dtype=torch.int32)
    ops.hash_insert(got_k, got_c, W.to_torch_words(keys)[0],
                    torch.from_numpy(w), None, sentinel_val=SENT32,
                    dropped=got_d, word_bits=32)
    for g, r in zip((got_k, got_c, got_d), want):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="word_bits"):
        ops.hash_insert(got_k, got_c, W.to_torch_words(keys)[0],
                        torch.from_numpy(w), None, sentinel_val=SENT32,
                        dropped=got_d)


# --- row 5: the lookup kernel's blocks, mirrored on the CPU -------------------
# `csrc/hash_table.cu`'s hash_lookup_kernel<bits>: a block of 256 threads
# covers 256 * 2 queries of a row, thread t taking queries lo + t and
# lo + t + 256; a block of padding zeroes its span and returns; the
# other blocks walk each thread's queries in lockstep from the hashed home
# slot and add the block's (hits, probe sum, longest walk) to its row.

LOOKUP_THREADS, LOOKUP_PER = 256, 2


def _mirror_lookup(tk, tc, keys, sent, bits):
    """The kernel's blocks over (rows, cap) table and (rows, n) query
    int64 arrays: (counts, probes, stats, writes), writes counting how
    often each output slot was written."""
    rows, n = keys.shape
    cap = tk.shape[1]
    words = keys.view(np.uint64) if bits == 64 else keys.astype(np.uint32)
    home = _mirror_home_slots(words, cap, bits).astype(np.int64)
    counts = np.full((rows, n), -7, np.int32)
    probes = np.full((rows, n), -7, np.int32)
    writes = np.zeros((rows, n), np.int32)
    stats = np.zeros((rows, 3), np.int64)
    span = LOOKUP_THREADS * LOOKUP_PER
    for r in range(rows):
        for lo in range(0, n, span):
            idx = (lo + np.arange(LOOKUP_THREADS)[:, None]
                   + np.arange(LOOKUP_PER)[None, :] * LOOKUP_THREADS)
            inb = idx < n
            at = np.minimum(idx, n - 1)
            key = np.where(inb, keys[r, at], sent)
            walk = key != sent
            if not walk.any():                       # a block of padding
                end = min(n, lo + span)
                counts[r, lo:end] = probes[r, lo:end] = 0
                writes[r, lo:end] += 2
                continue
            slot = np.where(walk, home[r, at], 0)
            steps = np.zeros(idx.shape, np.int64)
            hit = np.zeros(idx.shape, bool)
            for _ in range(cap):
                cur = tk[r, slot]
                steps += walk
                found = walk & (cur == key)
                hit |= found
                walk = walk & ~found & (cur != sent)
                slot = np.where(walk, (slot + 1) % cap, slot)
                if not walk.any():
                    break
            count = np.where(hit, tc[r, slot], 0)
            counts[r, idx[inb]] = count[inb]
            probes[r, idx[inb]] = steps[inb]
            writes[r, idx[inb]] += 2
            stats[r] += [(count > 0).sum(), steps.sum(), 0]
            stats[r, 2] = max(stats[r, 2], steps.max())
    return counts, probes, stats, writes


def _mirror_lookup_case(kind, bits, seed):
    """'tiled': 4 tiles of 1024 queries, each a live prefix (100, 0, 1024,
    700 long) as the query path's received batch; 'ragged': 3001 queries on
    a 78 %-full 257-slot table (long walks, wraps, a partial last block);
    'full': a full 16-slot table that misses sweep."""
    rng = np.random.default_rng(seed)
    sent = W.sentinel(bits)
    cap, n_keys, n = {"tiled": (4096, 1400, 4096), "ragged": (257, 200, 3001),
                      "full": (16, 40, 600)}[kind]
    keys = W.to_torch_words(_lookup_words(rng, 2 * n_keys, bits)
                            .reshape(2, n_keys))[0]
    tk = torch.full((2, cap), sent, dtype=torch.int64)
    tc = torch.zeros((2, cap), dtype=torch.int32)
    ops.hash_insert(tk, tc, keys, torch.from_numpy(
        rng.integers(1, 9, size=(2, n_keys)).astype(np.int32)), None,
        sentinel_val=sent, dropped=torch.zeros((2,), dtype=torch.int32),
        word_bits=bits)
    miss = W.to_torch_words(_lookup_words(rng, 2 * n, bits).reshape(2, n))[0]
    q = torch.where(torch.from_numpy(rng.random((2, n)) < 0.5),
                    keys.gather(1, torch.from_numpy(
                        rng.integers(0, n_keys, size=(2, n)))), miss)
    if kind == "tiled":
        live = torch.arange(1024).view(1, 1024) < torch.tensor(
            [100, 0, 1024, 700]).view(4, 1)
        q = torch.where(live.reshape(1, n), q, sent)
    else:
        q[:, ::7] = sent
    return tk, tc, q


@pytest.mark.parametrize("seed", [44, 45])
@pytest.mark.parametrize("kind", ["tiled", "ragged", "full"])
@pytest.mark.parametrize("bits", [32, 64])
def test_hash_lookup_block_mirror(kind, bits, seed):
    """Every output slot written once, and counts, probes and stats equal
    to the plain version's (`ref.hash_lookup` from `ref.home_slots`,
    `ref.lookup_stats`)."""
    tk, tc, q = _mirror_lookup_case(kind, bits, seed)
    sent = W.sentinel(bits)
    counts, probes, stats, writes = _mirror_lookup(
        tk.numpy(), tc.numpy(), q.numpy(), sent, bits)
    assert (writes == 2).all()
    want = ref.hash_lookup(tk, tc, q, ref.home_slots(q, tk.shape[1], bits),
                           sent)
    np.testing.assert_array_equal(counts, want[0].numpy())
    np.testing.assert_array_equal(probes, want[1].numpy())
    np.testing.assert_array_equal(stats, ref.lookup_stats(*want).numpy())
    assert int((want[0] > 0).sum()) > 0


# --- row 9: the packed-row extraction, mirrored on the CPU --------------------
# `csrc/kmer_extract.cu` stages a tile's codes from the 16-byte boundary
# below its first code, packs them into 64-bit words (F: first symbol most
# significant; L: first symbol least significant, for the reverse
# complement), and reads each window with one funnel shift of two words.
# This mirror walks the same tiles, packing (for b = 2 the multiply and
# byte-permute steps) and word index / shift arithmetic in numpy.

TILE_OUT, TILE_CODES = 8192, 16384
_U64 = np.uint64


def _byte_perm(x, y, s):
    """CUDA's __byte_perm for selectors 0-7 on uint32 arrays."""
    src = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    src += [(y >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(s >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def _pack_words(buf: np.ndarray, nchunks: int, b: int, canonical: bool):
    """The packed F (and L) words of `nchunks` staged 16-byte chunks, one
    zero word past them, as pack() computes them."""
    nw = (nchunks * 16 * b + 63) // 64 + 1
    data = np.zeros(64 * nw + 16 * nchunks + 64, np.uint8)
    data[:16 * nchunks] = buf[:16 * nchunks]
    if b == 2:
        x = data[:32 * nw].view("<u4").reshape(nw, 8)
        f = x * np.uint32(0x40100401)
        fhi = _byte_perm(_byte_perm(f[:, 0], f[:, 1], 0x3700),
                         _byte_perm(f[:, 2], f[:, 3], 0x0037), 0x3254)
        flo = _byte_perm(_byte_perm(f[:, 4], f[:, 5], 0x3700),
                         _byte_perm(f[:, 6], f[:, 7], 0x0037), 0x3254)
        fw = (fhi.astype(_U64) << _U64(32)) | flo.astype(_U64)
        if not canonical:
            return fw, None
        lw = x * np.uint32(0x01041040)
        llo = _byte_perm(_byte_perm(lw[:, 0], lw[:, 1], 0x0073),
                         _byte_perm(lw[:, 2], lw[:, 3], 0x0073), 0x5410)
        lhi = _byte_perm(_byte_perm(lw[:, 4], lw[:, 5], 0x0073),
                         _byte_perm(lw[:, 6], lw[:, 7], 0x0073), 0x5410)
        return fw, (lhi.astype(_U64) << _U64(32)) | llo.astype(_U64)
    fw = np.zeros(nw, _U64)
    for w in range(nw):
        lo, v = 64 * w, 0
        for s in range(lo // b, (lo + 63) // b + 1):
            c = int(data[s])
            sh = 64 - b - (s * b - lo)
            v |= (c << sh) & ((1 << 64) - 1) if sh >= 0 else c >> -sh
        fw[w] = v
    return fw, None


def _shl2(a, b, o):
    return (a << o) | ((b >> _U64(1)) >> (_U64(63) - o))


def _shr2(a, b, o):
    return (a >> o) | ((b << _U64(1)) << (_U64(63) - o))


def _mirror_kmer_extract(codes: np.ndarray, k: int, b: int,
                         canonical: bool, addr0: int = 0):
    """The kernel's tiles over (rows, m) uint8 codes whose first byte lies
    at an address of `addr0` mod 16: returns the words and how often each
    was written."""
    rows, m = codes.shape
    n_pos = m - k + 1
    flat = codes.reshape(-1)
    kb = k * b
    mask = _U64((1 << kb) - 1)
    if n_pos <= TILE_OUT:
        rb = min(TILE_OUT // n_pos, TILE_CODES // m)
        rb = rb & ~1 if rb > 1 else max(rb, 1)
        rb = min(rb, rows)
        T, tiles = n_pos, [(t * rb, min(rows, t * rb + rb))
                           for t in range(-(-rows // rb))]
        spans = [(r0 * m, r1 * m, r0 * n_pos, (r1 - r0) * n_pos)
                 for r0, r1 in tiles]
    else:
        T, per_row, rb = TILE_OUT, -(-n_pos // TILE_OUT), 1
        spans = []
        for r in range(rows):
            for pt in range(per_row):
                p0 = pt * TILE_OUT
                ln = min(TILE_OUT, n_pos - p0)
                spans.append((r * m + p0, r * m + p0 + ln + k - 1,
                              r * n_pos + p0, ln))
    out = np.zeros(rows * n_pos, _U64)
    writes = np.zeros(rows * n_pos, np.int64)
    for g0, g1, o0, ln in spans:
        off0 = (addr0 + g0) % 16
        nchunks = (off0 + g1 - g0 + 15) // 16
        buf = np.zeros(16 * nchunks, np.uint8)
        lo, hi = g0 - off0, g0 - off0 + 16 * nchunks
        buf[max(0, -lo):16 * nchunks - max(0, hi - flat.size)] = \
            flat[max(lo, 0):min(hi, flat.size)]
        fw, lw = _pack_words(buf, nchunks, b, canonical)
        e = np.arange(ln)
        x = off0 + (e // T) * m + e % T
        bit = x * b
        w, o = bit >> 6, (bit & 63).astype(_U64)
        fwd = _shl2(fw[w], fw[w + 1], o) >> _U64(64 - kb)
        if canonical:
            rc = ~_shr2(lw[w], lw[w + 1], o) & mask
            fwd = np.minimum(fwd, rc)
        out[o0:o0 + ln] = fwd
        writes[o0:o0 + ln] += 1
        # Tiles of several whole rows start at even words, so every pair
        # (2t, 2t + 1) is one 16-byte store.
        assert n_pos > TILE_OUT or rb == 1 or o0 % 2 == 0
    return out.reshape(rows, n_pos), writes


EXTRACT_MIRROR_CASES = [
    # (k, bits, canonical, rows, m, addr0): every k at 2 bits, canonical and
    # not; bits 1-8 at the widest k; m = k; odd n_pos (tiles at odd words);
    # rows longer than a tile (n_pos > 8192), with an odd row length; codes
    # that start off a 16-byte boundary.
    *[(k, 2, c, 5, 150, k % 16) for k in range(1, 32) for c in (False, True)],
    *[(62 // b, b, False, 7, 100, b) for b in range(1, 9)],
    *[(5, b, False, 3, 77, 0) for b in range(1, 9)],
    (31, 2, True, 40, 31, 3), (30, 2, True, 70, 150, 0),
    (15, 2, True, 300, 60, 9), (31, 2, True, 3, 4200, 0),
    (31, 2, True, 3, 4201, 5), (21, 2, False, 2, 9000, 1),
    (31, 2, True, 1, 4126, 0), (7, 8, False, 100, 64, 0),
    (31, 2, True, 3, 8223, 0), (31, 2, True, 2, 8300, 3),
    (7, 8, False, 2, 20000, 0), (31, 2, True, 120, 150, 0)]

_BODY_EXTRACT = """
from repro.kernels import ref
for i, (k, b, c) in enumerate(I["cases"].tolist()):
    O[f"w{i}"] = np.asarray(ref.kmer_extract_ref(
        jnp.asarray(I[f"c{i}"]), k, b, canonical=bool(c))).astype(np.uint64)
"""


def _extract_codes(i, case):
    k, b, _, rows, m, _ = case
    rng = np.random.default_rng(100 + i)
    codes = rng.integers(0, 1 << b, size=(rows, m), dtype=np.uint8)
    codes[0, :min(m, 40)] = 0                  # a poly-A run
    return codes


@pytest.fixture(scope="module")
def jax_extract(tmp_path_factory):
    inputs = {"cases": np.array([c[:3] for c in EXTRACT_MIRROR_CASES])}
    for i, case in enumerate(EXTRACT_MIRROR_CASES):
        inputs[f"c{i}"] = _extract_codes(i, case)
    return run_jax(tmp_path_factory.mktemp("extract"), _BODY_EXTRACT, inputs,
                   x64=True)


@pytest.mark.parametrize("i", range(len(EXTRACT_MIRROR_CASES)))
def test_kmer_extract_packed_window_mirror(jax_extract, i):
    """The kernel's tiles, packing and window arithmetic against the JAX
    package's `kmer_extract_ref`: every word written once and bit-equal."""
    case = EXTRACT_MIRROR_CASES[i]
    k, b, canonical, _, _, addr0 = case
    got, writes = _mirror_kmer_extract(_extract_codes(i, case), k, b,
                                       canonical, addr0)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, jax_extract[f"w{i}"])


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1, 257, 1 << 20, 188_743_680])
@pytest.mark.parametrize("bits", [32, 64])
def test_hash_insert_home_slots_on_card(bits, cap):
    """Row 4 with `slots=None`: the kernel's home slots. The table is set-
    equal to the plain version's with the same drop signal; every inserted
    key is then found with its count by `hash_lookup` from `store_slots`
    and by `store_lookup` (the lookup kernel's own home slots), whose stats
    count each as a hit (a wrong home slot hides the key); a `store_grow`
    rehash on the card keeps the set."""
    from repro_torch.core import countstore

    dev = _cuda()
    sent = W.sentinel(bits)
    g = torch.Generator().manual_seed(cap + bits)
    hi = 1 << 62 if bits == 64 else 1 << 32
    pool = torch.randint(0, hi, (2, min(cap + 50, 3000)), generator=g)
    if bits == 64:
        pool[:, ::2] |= -(1 << 63)             # the top bit set
    pool[:, 1::5] = sent - 1 if bits == 32 else -2
    keys = pool.gather(1, torch.randint(0, pool.shape[1], (2, 5000),
                                        generator=g))
    keys[:, ::13] = sent
    w = torch.randint(0, 4, keys.shape, generator=g, dtype=torch.int32)
    st = countstore.empty_store(2, cap, bits, dev)
    countstore.store_insert(st, keys.to(dev), w.to(dev))
    pt = countstore.empty_store(2, cap, bits)
    countstore.store_insert(pt, keys, w)
    torch.cuda.synchronize()
    dk, dc, dd = st.keys.cpu(), st.counts.cpu(), st.dropped.cpu()
    for r in range(2):
        assert (int(dd[r]) > 0) == (int(pt.dropped[r]) > 0)
        occ, pocc = dk[r] != sent, pt.keys[r] != sent
        got = sorted(zip(dk[r][occ].tolist(), dc[r][occ].tolist()))
        if int(pt.dropped[r]) == 0:
            assert got == sorted(zip(pt.keys[r][pocc].tolist(),
                                     pt.counts[r][pocc].tolist()))
        else:   # a full table: which keys win the slots may differ
            assert len(got) == cap
    live = st.keys != sent
    counts, _ = ops.hash_lookup(st.keys, st.counts, st.keys,
                                countstore.store_slots(st.keys, cap, bits),
                                sentinel_val=sent)
    assert torch.equal(counts[live], st.counts[live])
    stats = torch.zeros((2, 3), dtype=torch.int64, device=dev)
    counts, _ = countstore.store_lookup(st, st.keys, stats)
    assert torch.equal(counts[live], st.counts[live])
    assert torch.equal(stats[:, 0], (live & (st.counts > 0)).sum(1))
    if int(dd.sum()) == 0:
        grown = countstore.store_grow(st, 2 * cap + 1)
        torch.cuda.synchronize()
        gk = grown.keys.cpu()
        for r in range(2):
            occ = gk[r] != sent
            assert sorted(gk[r][occ].tolist()) == sorted(
                dk[r][dk[r] != sent].tolist())
        counts, _ = countstore.store_lookup(grown, st.keys)
        assert torch.equal(counts[live], st.counts[live])


# --- row 1: the plan's prefix written by the histogram kernel -----------------
# Where a row's (tiles, B) table fits PREFIX_MAX_CELLS, the block of the
# row's last ticket scans the whole table in shared memory; the mirror below
# does that scan as the kernel does (256 threads, each a chunk of
# consecutive cells of the bucket-major, tile-major sequence).

def _prefix_case(kind: str, rows: int, n: int, b_count: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, b_count, size=(rows, n)).astype(np.int32)
    if kind == "invalid":
        ids[:, ::5] = -1
        ids[:, 2::7] = b_count
    elif kind == "one bucket":
        ids[:] = b_count - 1
    return ids


def _jax_prefix(ids: np.ndarray, b_count: int):
    """The JAX plan's prefix, `bucket_start + tiles_before` of
    `bucket_hist_ref` (repro/kernels/radix_partition.py), row by row. JAX's
    bincount clips an id of -1 into bucket 0, so every id outside [0, B)
    goes to the JAX side as B, which it drops, as the port's kernel drops
    every id outside [0, B); a ragged last tile is padded the same way."""
    out = []
    for row in ids:
        pad = (-row.size) % ops.TILE
        j = np.where((row >= 0) & (row < b_count), row, b_count)
        j = np.concatenate([j, np.full(pad, b_count, np.int32)])
        hist = jref.bucket_hist_ref(jnp.asarray(j), b_count, ops.TILE)
        totals = hist.sum(axis=0)
        bucket_start = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32),
             jnp.cumsum(totals)[:-1].astype(jnp.int32)])
        tiles_before = (jnp.cumsum(hist, axis=0) - hist).astype(jnp.int32)
        out.append((np.asarray(bucket_start[None, :] + tiles_before),
                    np.asarray(totals), np.asarray(bucket_start)))
    return [np.stack(x) for x in zip(*out)]


def _mirror_prefix_block(counts: np.ndarray):
    """The last block's scan of one row's (T, B) counts in the kernel: the
    counts transposed into shared memory, cell (t, b) at b * T + t, each
    of the 256 threads stepping through (t, b) by the block's 256 cells;
    thread j sums cells [j * per, (j + 1) * per), per odd; an exclusive
    scan over the thread sums; each chunk written back as running bases;
    then starts are the tile-0 bases and totals the differences of the
    next start (the row's total for the last bucket)."""
    threads = 256
    t_count, b_count = counts.shape
    flat = counts.astype(np.int64).reshape(-1)
    n_cells = flat.size
    table = np.zeros(n_cells, np.int64)
    step_t, step_b = divmod(threads, b_count)
    for j in range(threads):
        t, b = divmod(j, b_count)
        for c in range(j, n_cells, threads):
            table[b * t_count + t] = flat[c]
            t, b = t + step_t, b + step_b
            if b >= b_count:
                t, b = t + 1, b - b_count
    assert (table == counts.T.reshape(-1)).all()
    per = -(-n_cells // threads) | 1
    chunks = [(min(j * per, n_cells), min(j * per + per, n_cells))
              for j in range(threads)]
    sums = [int(table[f0:f1].sum()) for f0, f1 in chunks]
    before = np.cumsum(sums) - sums
    for (f0, f1), run in zip(chunks, before):
        for f in range(f0, f1):
            table[f], run = run, run + table[f]
    base = table.reshape(b_count, t_count).T
    starts = base[0]
    nxt = np.append(starts[1:], sum(sums))
    return base, nxt - starts, starts


def _tiles_at_limit(b_count: int) -> int:
    """The most tiles a row may have for its (tiles, B) table to fit."""
    from repro_torch.kernels.radix_partition import PREFIX_MAX_CELLS
    return PREFIX_MAX_CELLS // b_count


PREFIX_CASES = [
    ("random", 2, 4096, 2), ("random", 3, 5000, 9), ("random", 2, 9000, 257),
    ("random", 2, 3001, 1024), ("invalid", 3, 5000, 9),
    ("invalid", 2, _tiles_at_limit(1024) * 1024, 1024),
    ("random", 1, _tiles_at_limit(1024) * 1024 + 1, 1024),
    ("random", 1, _tiles_at_limit(257) * 1024, 257),
    ("one bucket", 1, _tiles_at_limit(257) * 1024 + 1000, 257)]


@pytest.mark.parametrize("kind,rows,n,b_count", PREFIX_CASES)
def test_bucket_prefix_plain_matches_jax(kind, rows, n, b_count):
    """(base, totals, starts) equal the JAX plan's prefix at B = 2 to 1024,
    ragged last tiles, ids of -1 and B, and rows whose (tiles, B) table
    lies on either side of PREFIX_MAX_CELLS (at B = 1024 and 257)."""
    ids = _prefix_case(kind, rows, n, b_count, n + b_count)
    got = ops.bucket_prefix(torch.from_numpy(ids), b_count)
    for g, want in zip(got, _jax_prefix(ids, b_count)):
        np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("kind,rows,n,b_count", PREFIX_CASES[:6])
def test_bucket_prefix_block_scan_mirror(kind, rows, n, b_count):
    ids = torch.from_numpy(_prefix_case(kind, rows, n, b_count, 7))
    hist = ops.bucket_hist(ids, b_count)
    want = ops.bucket_prefix(ids, b_count)
    for r in range(rows):
        for g, w in zip(_mirror_prefix_block(hist[r].numpy()), want):
            np.testing.assert_array_equal(g, w[r].numpy())


def test_prefix_limit_fits_shared_memory():
    from repro_torch.kernels.radix_partition import PREFIX_MAX_CELLS
    assert PREFIX_MAX_CELLS * 4 <= 47 * 1024
    assert 30 * 257 <= PREFIX_MAX_CELLS   # a scan step's radix pass


@pytest.mark.gpu
@pytest.mark.parametrize("kind,rows,n,b_count", PREFIX_CASES + [
    ("random", 8, 30720, 257), ("invalid", 8, 61440, 9),
    ("random", 8, _tiles_at_limit(2) * 1024, 2),
    ("random", 2, _tiles_at_limit(2) * 1024 + 1, 2)])
def test_bucket_prefix_kernel_matches_plain_on_card(kind, rows, n, b_count):
    """The prefix in the kernel where a row's table fits PREFIX_MAX_CELLS
    (one launch of bucket_prefix), else the plain counts' launch and the
    prefix in tensor code; bit-equal to the plain version either way."""
    from repro_torch.kernels.radix_partition import PREFIX_MAX_CELLS

    dev = _cuda()
    ids = torch.from_numpy(_prefix_case(kind, rows, n, b_count, 5))
    ops.reset_launches()
    got = ops.bucket_prefix(ids.to(dev), b_count)
    torch.cuda.synchronize()
    fits = -(-n // ops.TILE) * b_count <= PREFIX_MAX_CELLS
    assert (ops.bucket_prefix.launches, ops.bucket_hist.launches) == (
        (1, 0) if fits else (0, 1))
    for g, w in zip(got, ref.bucket_prefix(ids, b_count, ops.TILE)):
        assert torch.equal(g.cpu(), w)


# --- row 3: one launch with a decoupled look-back, mirrored on the CPU --------
# csrc/segment_count.cu scans (run starts, weight since the latest start)
# over a row in one launch: tiles in ticket order, each publishing its
# aggregate and then its inclusive prefix, found by warp 0 of later tiles
# 32 tiles at a time. The mirror below keeps the kernel's device state (the
# epoch and ticket word, a tag and two packed values per tile) across
# launches, and runs the blocks interleaved in a seeded random order.

_M32 = 0xFFFFFFFF


def _combine(a, b):
    return ((a[0] + b[0]) & _M32, b[1] if b[0] else (a[1] + b[1]) & _M32)


def _pack(s):
    return (s[1] << 32) | s[0]


def _unpack(x):
    return (x & _M32, x >> 32)


class _LookBackState:
    def __init__(self, tiles):
        self.ctr = 0   # the epoch above the launch's tickets
        self.tags = [0] * tiles
        self.agg = [0] * tiles
        self.inc = [0] * tiles


def _butterfly(v):
    """Warp 0's combine of 32 lanes' values, lane 31 the earliest tile."""
    v = list(v)
    o = 1
    while o < 32:
        v = [_combine(v[lane], v[lane ^ o]) if lane & o
             else _combine(v[lane ^ o], v[lane]) for lane in range(32)]
        o <<= 1
    assert len(set(v)) == 1
    return v[0]


def _mirror_accumulate(state, keys, w, sent, rng, compact, resident):
    """One launch of segment_accumulate_kernel over (rows, n) int64 words
    and int32 weights (None: 1 a valid word), at most `resident` blocks
    running at once. Returns the flags mode's or the compacting mode's
    outputs (the compacting outputs' unwritten slots hold the sentinel and
    0, as the wrapper's fills leave them)."""
    rows, n = keys.shape
    n_tiles = -(-n // 1024)
    total = rows * n_tiles
    is_new = np.zeros((rows, n), bool)
    is_end = np.zeros((rows, n), bool)
    run_tot = np.zeros((rows, n), np.int64)
    unique = np.full((rows, n), sent, np.int64)
    counts = np.zeros((rows, n), np.int64)
    num_unique = np.full(rows, -1, np.int64)

    def block():
        word = state.ctr
        state.ctr += 1
        g, epoch = word & _M32, word >> 32
        if g == total - 1:
            state.ctr += (1 << 32) - total
        yield
        row, tile = divmod(g, n_tiles)
        lo = tile * 1024
        k = np.full(1024, sent, np.int64)
        k[:min(1024, n - lo)] = keys[row, lo:lo + 1024]
        prev = np.concatenate([[keys[row, lo - 1] if lo else sent], k[:-1]])
        nxt = np.concatenate([k[1:], [keys[row, lo + 1024]
                                      if lo + 1024 < n else sent]])
        valid = k != sent
        new = valid & (k != prev)
        end = valid & (k != nxt)
        wt = np.zeros(1024, np.int64)
        m = min(1024, n - lo)
        wt[:m] = 1 if w is None else w[row, lo:lo + m].astype(np.int64) & _M32
        wt[~valid] = 0
        items = [(int(new[i]), int(wt[i])) for i in range(1024)]
        thread = []
        for t in range(256):
            s = (0, 0)
            for i in range(4 * t, 4 * t + 4):
                s = _combine(s, items[i])
            thread.append(s)
        before, agg_all = [], (0, 0)
        for s in thread:
            before.append(agg_all)
            agg_all = _combine(agg_all, s)
        tag = (epoch + 1) << 1
        excl = (0, 0)
        if tile == 0:
            state.inc[g], state.tags[g] = _pack(agg_all), tag | 1
        else:
            state.agg[g], state.tags[g] = _pack(agg_all), tag
            yield
            first, top = g - tile, g - 1
            while True:
                ps = [top - lane for lane in range(32)]
                while True:
                    tags = [state.tags[p] if p >= first else 0 for p in ps]
                    if all(p < first or (t | 1) == (tag | 1)
                           for p, t in zip(ps, tags)):
                        break
                    yield
                done = [p < first or bool(t & 1) for p, t in zip(ps, tags)]
                v = [(0, 0) if p < first else
                     _unpack((state.inc if d else state.agg)[p])
                     for p, d in zip(ps, done)]
                if any(done):
                    stop = done.index(True)
                    v = [x if lane <= stop else (0, 0)
                         for lane, x in enumerate(v)]
                excl = _combine(_butterfly(v), excl)
                if any(done):
                    break
                top -= 32
            state.inc[g], state.tags[g] = _pack(_combine(excl, agg_all)), \
                tag | 1
        yield
        for t in range(256):
            run = _combine(excl, before[t])
            for i in range(4 * t, 4 * t + 4):
                run = _combine(run, items[i])
                e = lo + i
                if e >= n:
                    continue
                tot = run[1] if end[i] else 0
                if compact:
                    if new[i]:
                        unique[row, run[0] - 1] = k[i]
                    if end[i]:
                        counts[row, run[0] - 1] = tot
                    if e == n - 1:
                        num_unique[row] = run[0]
                else:
                    is_new[row, e], is_end[row, e] = new[i], end[i]
                    run_tot[row, e] = tot

    waiting, running = total, []
    while waiting or running:
        if waiting and (len(running) < resident
                        and (not running or rng.random() < 0.3)):
            running.append(block())
            waiting -= 1
        b = running[rng.integers(len(running))]
        try:
            next(b)
        except StopIteration:
            running.remove(b)
    as32 = lambda x: ((x + (1 << 31)) & _M32) - (1 << 31)   # noqa: E731
    if compact:
        return unique, as32(counts), num_unique
    return is_new, is_end, as32(run_tot)


def _accum_rows(name: str, bits: int, seed: int):
    """(keys (rows, n) uint32 / uint64, weights (rows, n) int32 or None) of
    an accumulate case: sorted rows with sentinel tails."""
    rows, n, nd, long_run, wkind = ACCUM_CASES[name]
    rng = np.random.default_rng(seed)
    dtype = np.uint32 if bits == 32 else np.uint64
    sent = np.uint32(SENT32) if bits == 32 else np.iinfo(np.uint64).max
    keys, w = zip(*(_sorted_runs(rng, n, nd, sent, dtype, long_run)
                    for _ in range(rows)))
    keys, w = np.stack(keys), np.stack(w)
    if bits == 64:
        keys[keys != sent] |= np.uint64(1 << 61)
    if name == "all_sentinel":
        keys[1] = sent
    if wkind == "wrap":   # run sums far past 2**31
        w = rng.integers(1 << 29, (1 << 31) - 1, size=w.shape).astype(
            np.int32)
    return keys, None if wkind == "ones" else w


# name: (rows, n, distinct keys, one long run, weights)
ACCUM_CASES = {
    "random": (2, 9000, 3000, 0, "small"),
    "long_run": (1, 70_000, 40, 60_000, "small"),
    "all_sentinel": (3, 5000, 10, 0, "small"),
    "wrap": (2, 40_000, 5, 30_000, "wrap"),
    "ones": (2, 9000, 700, 0, "ones"),
    "ragged": (3, 4099, 7, 0, "small"),
}


@pytest.mark.parametrize("name", sorted(ACCUM_CASES))
def test_segment_accumulate_look_back_mirror(name):
    """The mirror's flags equal the JAX kernel's (interpret mode) and its
    compacted runs the JAX `accumulate`, over three launches on one device
    state (a launch's stale tags must never match a later one's), blocks
    interleaved in seeded random orders, 1 to 64 running at once. Where
    run sums wrap int32 ('wrap'), the flags are held to the JAX kernel's
    own oracle, `segment_accumulate_ref`: the Pallas kernel takes each
    run's base with a cummax of its tile's running int32 sum, which is
    right only while that sum does not wrap; the compacted runs there are
    held to the JAX `accumulate(impl='segment_sum')`."""
    from repro.core import sort as jsort

    keys, w = _accum_rows(name, 32, 21)
    rows, n = keys.shape
    kt = keys.astype(np.int64)
    wj = np.ones_like(keys, np.int32) if w is None else w
    rng = np.random.default_rng(len(name))
    state = _LookBackState(rows * -(-n // 1024) + 64)
    _mirror_accumulate(state, kt[:, :n // 3 + 1], None, SENT32, rng, False,
                       4)
    flags = _mirror_accumulate(state, kt, w, SENT32, rng, False,
                               int(rng.integers(1, 65)))
    compact = _mirror_accumulate(state, kt, w, SENT32, rng, True, 64)
    pad = (-n) % 1024   # the JAX kernel takes whole tiles of padding
    for r in range(rows):
        jk = jnp.asarray(np.append(keys[r], [SENT32] * pad).astype(np.uint32))
        jw = jnp.asarray(np.append(wj[r], [0] * pad).astype(np.int32))
        want = (jref.segment_accumulate_ref(jk, jw, SENT32) if name == "wrap"
                else jops.segment_accumulate(jk, jw, sentinel_val=SENT32,
                                             tile=1024))
        for g, x in zip(flags, want):
            np.testing.assert_array_equal(g[r], np.asarray(x)[:n])
        acc = jsort.accumulate(jnp.asarray(keys[r]), jnp.asarray(wj[r]),
                               sentinel_val=SENT32,
                               impl="segment_sum" if name == "wrap"
                               else "fused")
        np.testing.assert_array_equal(compact[0][r], np.asarray(acc.unique))
        np.testing.assert_array_equal(compact[1][r], np.asarray(acc.counts))
        assert compact[2][r] == int(acc.num_unique)
    assert state.ctr == 3 << 32   # three epochs, no ticket left taken


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("name", sorted(ACCUM_CASES))
def test_segment_accumulate_compact_plain_matches_flags(bits, name):
    """The compacting mode's plain version against the flags mode's:
    run r's key and total at slot r, the sentinel and 0 past num_unique."""
    keys, w = _accum_rows(name, bits, 23)
    kt = W.to_torch_words(keys)[0]
    wt = None if w is None else torch.from_numpy(w)
    sent = W.sentinel(bits)
    is_new, is_end, tot = ops.segment_accumulate(kt, wt, sentinel_val=sent)
    unique, counts, num_unique = ops.segment_accumulate(
        kt, wt, sentinel_val=sent, compact=True)
    for r in range(kt.shape[0]):
        nu = int(num_unique[r])
        assert nu == int(is_new[r].sum()) == int(is_end[r].sum())
        assert torch.equal(unique[r, :nu], kt[r][is_new[r]])
        assert torch.equal(counts[r, :nu], tot[r][is_end[r]])
        assert bool((unique[r, nu:] == sent).all())
        assert bool((counts[r, nu:] == 0).all())


def test_rows_1_and_3_wrappers_take_only_cuda_tensors():
    """The kernel wrappers behind ops.bucket_prefix and
    ops.segment_accumulate refuse a tensor off the card: only ops sends a
    CPU tensor to the plain version."""
    from repro_torch.kernels import radix_partition, segment_count

    ids = torch.zeros((1, 8), dtype=torch.int32)
    keys = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        radix_partition.bucket_prefix_cuda(ids, 2)
    for compact in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            segment_count.segment_accumulate_cuda(keys, None, -1, compact)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("name", sorted(ACCUM_CASES) + ["row_2_24"])
def test_segment_accumulate_modes_match_plain_on_card(bits, name):
    """Both modes of the one-launch kernel against their plain versions,
    and sort.accumulate(impl='fused') against 'segment_sum', at the mirror's
    cases and a row of 2**24 + 5 elements."""
    from repro_torch.core import sort

    dev = _cuda()
    sent = W.sentinel(bits)
    if name == "row_2_24":
        g = torch.Generator().manual_seed(bits)
        n = (1 << 24) + 5
        kt = torch.sort(torch.randint(0, 1 << 22, (1, n), generator=g),
                        dim=1).values
        kt[:, n - n // 9:] = sent
        wt = torch.randint(1, 6, (1, n), generator=g, dtype=torch.int32)
    else:
        keys, w = _accum_rows(name, bits, 29)
        kt = W.to_torch_words(keys)[0]
        wt = None if w is None else torch.from_numpy(w)
    dk, dw = kt.to(dev), None if wt is None else wt.to(dev)
    for compact in (False, True):
        got = ops.segment_accumulate(dk, dw, sentinel_val=sent,
                                     compact=compact)
        torch.cuda.synchronize()
        want = ops.segment_accumulate(kt, wt, sentinel_val=sent,
                                      compact=compact)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_.cpu(), w_)
    fused = sort.accumulate(dk, dw, sentinel_val=sent, impl="fused")
    oracle = sort.accumulate(dk, dw, sentinel_val=sent, impl="segment_sum")
    for f in fused._fields:
        assert torch.equal(getattr(fused, f), getattr(oracle, f))
