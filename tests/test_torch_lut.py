"""The decode kernels' lookup table (metalhuffman_tpu_torch.ops.decode_cuda:
``lookup_entries``, staged in a ``Code`` by ``stage_code``) against the
interval decode, and its routing through the staging and the wrappers.

The table must be the interval decode of the JAX package's Pallas kernels,
tabulated: the same (width, symbol) on every one of the 65,536 16-bit
windows, for every width table, malformed ones included, since the kernels
are held to the plain versions byte for byte and end bit for end bit on any
stream. The reference here is that interval decode, computed in numpy from
the JAX package's ``canonical_meta`` (no JAX compile). Every comparison is
exact: tolerance 0.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from metalhuffman_tpu import native as jnative
from metalhuffman_tpu.models import CodecConfig as JCodecConfig
from metalhuffman_tpu.models import frame_stream as jfs
from metalhuffman_tpu.ops import decode_pallas
from metalhuffman_tpu_torch import _build, native
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models import image_codec as tic
from metalhuffman_tpu_torch.models.config import CodecConfig
from metalhuffman_tpu_torch.ops import decode_cuda
from metalhuffman_tpu_torch.utils import fixtures

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WINDOWS = np.arange(1 << 16, dtype=np.int64)


def _encoder_sets():
    """The five sets of tests/test_encode_pallas.py, same seed and order."""
    rng = np.random.default_rng(7)
    yield "uniform", rng.integers(0, 256, 64 * 200, np.uint8)
    p = 0.8 ** np.arange(32)
    yield "skewed", rng.choice(np.arange(32), size=64 * 300 + 17,
                               p=p / p.sum()).astype(np.uint8)
    yield "constant", np.full(64 * 10 + 5, 9, np.uint8)
    yield "two-sym", rng.choice([7, 200], size=64 * 130,
                                p=[0.93, 0.07]).astype(np.uint8)
    adv = np.concatenate([np.full(2 ** i, i, np.uint8) for i in range(24)])
    rng.shuffle(adv)
    yield "longcodes", adv[: adv.size // 64 * 64]


def _table_widths():
    """name -> widths: the seven tables of the probes' tests (the encoder
    tests' five, the photo's, one of 127 secondary tables at 8/8) and two
    malformed ones: 256 16-bit codes, whose windows all escape, and an
    incomplete two-symbol code (0 and 100), whose windows past 101 decode to
    16-bit garbage."""
    out = {name: jnative.code_lengths(np.bincount(d, minlength=256))
           for name, d in _encoder_sets()}
    out["photo"] = jfs.encode_frames_shared(fixtures.photo()[None],
                                            JCodecConfig()).widths
    wide = np.full(256, 9, np.uint8)
    wide[0], wide[1] = 1, 8
    out["127-t2"] = wide
    out["all-16"] = np.full(256, 16, np.uint8)
    out["incomplete"] = np.zeros(256, np.uint8)
    out["incomplete"][5], out["incomplete"][200] = 1, 3
    return out


TABLES = _table_widths()
K1 = decode_cuda.LUT_K1


def _reference(widths):
    """(width, symbol) of every window by the JAX package's interval
    table: B_L compares, adj = cumsum(adj_inc), the pair table's order."""
    ref = decode_pallas.canonical_meta(widths)
    adj = np.cumsum(np.asarray(ref.adj_inc, np.int64))
    pair = ref.pair_table[0].astype(np.int64)
    order = np.empty(256, np.int64)
    order[0::2], order[1::2] = pair & 0xFF, (pair >> 8) & 0xFF
    w = 1 + (WINDOWS[:, None] >= np.asarray(ref.bounds[1:], np.int64)).sum(1)
    return w, order[(adj[w - 1] + (WINDOWS >> (16 - w))) & 255]


def _lookup(entries):
    """The kernels' two-level lookup (decode_common.cuh::decode_group_lut)
    of every window, in numpy -> (width, symbol)."""
    e = entries.astype(np.int64)
    k2 = 16 - K1
    got = e[WINDOWS >> k2]
    esc = (got & decode_cuda.ESCAPE) != 0
    got[esc] = e[(1 << K1) + (((got[esc] ^ decode_cuda.ESCAPE) << k2)
                              | (WINDOWS[esc] & ((1 << k2) - 1)))]
    return got >> 8, got & 0xFF


@pytest.mark.parametrize("name", TABLES)
def test_lookup_table_is_the_interval_decode_on_every_window(name):
    widths = TABLES[name]
    entries = decode_cuda.lookup_entries(decode_cuda.canonical_meta(widths))
    assert entries.dtype == np.uint16
    t1 = entries[: 1 << K1].astype(np.int64)
    t2 = entries[1 << K1:].astype(np.int64)
    n_t2 = t2.size >> (16 - K1)
    assert t2.size == n_t2 << (16 - K1)
    # escapes name the secondary tables in order, once each
    esc = (t1 & decode_cuda.ESCAPE) != 0
    np.testing.assert_array_equal(t1[esc] ^ decode_cuda.ESCAPE,
                                  np.arange(n_t2))
    # no entry of either level decodes to width 0, no direct T1 entry is
    # wider than K1, and no entry is zero
    widths_t1 = t1[~esc] >> 8
    assert ((widths_t1 >= 1) & (widths_t1 <= K1)).all()
    assert ((t2 >> 8 >= 1) & (t2 >> 8 <= 16)).all()
    assert (entries != 0).all()
    w, sym = _lookup(entries)
    ref_w, ref_sym = _reference(widths)
    np.testing.assert_array_equal(w, ref_w)
    np.testing.assert_array_equal(sym, ref_sym)
    np.testing.assert_array_equal(
        np.stack(decode_cuda.interval_windows(
            decode_cuda.canonical_meta(widths))), np.stack([ref_w, ref_sym]))


def _table(name):
    return decode_cuda.stage_code(TABLES[name], "cpu")


def test_lookup_table_sizes():
    t1 = 2 << K1  # 4 KB
    assert decode_cuda.T2_SMEM_MAX_BYTES == 64 * 1024
    # a malformed table escapes from every prefix: 132 KB, T2 through L1
    assert _table("all-16").nbytes == t1 + 2048 * 64 == 135168
    # every code of the 127-table case at 8/8 fits T1 at 11 bits
    assert _table("127-t2").num_t2 == 0
    # the photo's codes past 11 bits: 43 secondary tables, 6.7 KB
    assert _table("photo").num_t2 == 43
    # the one-symbol table: windows past its code decode to 16-bit garbage,
    # a secondary table for each of their 1024 prefixes, T2 through L1
    assert _table("constant").nbytes == t1 + 1024 * 64 == 69632
    # the incomplete code's 768 garbage prefixes: 52 KB, shared memory
    # past the 48 KB a kernel gets without opting in
    assert _table("incomplete").nbytes == t1 + 768 * 64 == 53248
    assert [_table(n).t2_in_smem for n in ("all-16", "constant",
                                           "incomplete", "photo")] == \
        [False, False, True, True]


def test_complete_codes_stay_far_below_the_shared_memory_limit():
    # a prefix escapes only when it holds two or more codes longer than
    # K1 bits, so a complete code of 256 symbols has at most 128 secondary
    # tables: 12 KB, and only the one-symbol code and malformed tables read
    # T2 through L1
    worst = t1 = 1 << K1
    for name in ("uniform", "skewed", "two-sym", "longcodes", "photo",
                 "127-t2"):
        worst = max(worst, _table(name).entries.numel())
    assert (worst - t1) >> (16 - K1) <= 128
    assert 2 * (t1 + (128 << (16 - K1))) == 12288


def test_lookup_entries_are_cached_read_only():
    meta = decode_cuda.canonical_meta(TABLES["photo"])
    assert decode_cuda.lookup_entries(meta) is decode_cuda.lookup_entries(meta)
    with pytest.raises(ValueError):  # the cached entries are read-only
        decode_cuda.lookup_entries(meta)[0] = 0


def _random_words(seed, n_words=512, n_blocks=64):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, n_words, dtype=np.uint64)
    offsets = rng.integers(0, 32 * n_words, n_blocks, dtype=np.uint64)
    return (torch.from_numpy(words.astype(np.uint32).view(np.int32)),
            torch.from_numpy(offsets.astype(np.uint32).view(np.int32)))


@pytest.mark.parametrize("name", ["constant", "longcodes", "all-16",
                                  "incomplete"])
def test_lookup_decode_of_garbage_equals_the_plain_version(name):
    # the kernels' step (refill, lookup, shift by the width) on random words
    # at random offsets, in numpy, against the plain interval decode
    meta = decode_cuda.canonical_meta(TABLES[name])
    words, offsets = _random_words(sum(map(ord, name)))
    plain, end = decode_cuda._decode_plain(words, offsets, _table(name), 16, 0)
    w64 = words.numpy().view(np.uint32).astype(np.uint64)
    pos = offsets.numpy().view(np.uint32).astype(np.uint64)
    start = pos.copy()
    lw, lsym = _lookup(decode_cuda.lookup_entries(meta))
    p = start.copy()
    out = np.zeros((p.size, 16), np.int64)
    for g in range(4):
        wi = np.minimum(p >> np.uint64(5), np.uint64(w64.size - 3))
        s = p & np.uint64(31)
        # decode_common.cuh::refill: 64 bits left-justified at p
        win = ((((w64[wi] << np.uint64(32)) | w64[wi + 1]) << s)
               | (w64[wi + 2] >> (np.uint64(32) - s)))
        t = np.zeros_like(p)
        for k in range(4):
            window = ((win << t) >> np.uint64(48)).astype(np.int64)
            out[:, 4 * g + k] = lsym[window]
            t += lw[window].astype(np.uint64)
        p += t
    np.testing.assert_array_equal(out, plain.numpy())
    np.testing.assert_array_equal(((start & np.uint64(31)) + (p - start))
                                  .astype(np.int32), end.numpy())


def test_kernel_constants_match_the_wrapper():
    src = (ROOT / "metalhuffman_tpu_torch/csrc/decode_common.cuh").read_text()
    assert re.search(r"kEscape = 0x8000;", src)
    assert decode_cuda.ESCAPE == 0x8000
    assert re.search(r"kT2SmemMaxBytes = 64 \* 1024;", src)
    assert decode_cuda.T2_SMEM_MAX_BYTES == 64 * 1024
    assert re.search(r"kK1 = 11;", src)
    assert decode_cuda.LUT_K1 == 11
    # B1 refills through L1, B2 feeds the same symbol step from its own
    # feed; neither runs the interval step
    for name, step in (("decode_images", "decode_group_lut<"),
                       ("decode_blocks", "decode_window_lut<")):
        kernel = (ROOT / f"metalhuffman_tpu_torch/csrc/{name}.cu").read_text()
        assert f"mht_{name}_shape(" in kernel
        assert step in kernel and "decode_group<" not in kernel
        assert "stage_lut(" in kernel and "launch_facts(" in kernel
    blocks = (ROOT / "metalhuffman_tpu_torch/csrc/decode_blocks.cu").read_text()
    assert re.search(rf"kAheadMinBytes = {decode_cuda.AHEAD_MIN_BYTES};",
                     blocks)
    assert "4 * n_words / n_blocks + 1" in blocks


# -- routing ------------------------------------------------------------------

def _stream(t=2, h=16, w=24, cfg=None):
    frames = fixtures.synthetic(t, h, w)
    return frames, tfs.encode_frames_shared(frames, cfg)


def test_prepare_shared_stages_the_table():
    frames, stream = _stream()
    prep = tfs.prepare_shared(stream, 2, 16, 24, device="cpu")
    assert isinstance(prep.code, decode_cuda.Code)
    assert prep.code.entries.dtype == torch.int16
    assert prep.code.entries.device == prep.words.device
    np.testing.assert_array_equal(
        prep.code.entries.numpy().view(np.uint16),
        decode_cuda.lookup_entries(decode_cuda.canonical_meta(stream.widths)))
    out = tfs.decode_shared_step(prep)
    np.testing.assert_array_equal(out.numpy(), frames)


@pytest.mark.parametrize("bd", [4, 8])
def test_decode_blocks_selection_stages_the_table(monkeypatch, bd):
    frames, stream = _stream(1, 32, 48, CodecConfig(block_dim=bd))
    seen = []
    original = decode_cuda.decode_blocks

    def spy(*args, **kwargs):
        seen.append(args[2])  # the code
        return original(*args, **kwargs)

    monkeypatch.setattr(decode_cuda, "decode_blocks", spy)
    sel = np.array([3, 0, 5, 3])
    img = tic.decode_blocks_selection(stream, sel, bd, 4 * bd,
                                      CodecConfig(block_dim=bd), device="cpu")
    assert len(seen) == 1 and isinstance(seen[0], decode_cuda.Code)
    np.testing.assert_array_equal(
        seen[0].entries.numpy().view(np.uint16),
        decode_cuda.lookup_entries(decode_cuda.canonical_meta(stream.widths)))
    bw = 48 // bd
    want = np.concatenate([frames[0, (b // bw) * bd:(b // bw + 1) * bd,
                                  (b % bw) * bd:(b % bw + 1) * bd]
                           for b in sel], axis=1)
    np.testing.assert_array_equal(img.numpy(), want)


@pytest.fixture
def as_cuda(monkeypatch):
    """CPU tensors routed as CUDA ones, with the launch recorded instead of
    made: the wrappers' CUDA path, up to the C call, without a card."""
    calls = []
    real = decode_cuda._check_inputs
    monkeypatch.setattr(decode_cuda, "_check_inputs",
                        lambda *a: "cuda" if real(*a) == "cpu" else "?")
    monkeypatch.setattr(_build, "launch",
                        lambda name, device, *args: calls.append((name, args)))
    return calls


def _staged(cfg=None):
    _frames, stream = _stream(2, 16, 24, cfg)
    prep = tfs.prepare_shared(stream, 2, 16, 24, cfg, device="cpu")
    return prep, (prep.words, prep.offsets)


@pytest.mark.parametrize("name", TABLES)
def test_stage_code_holds_both_tables_and_stays_on_its_device(as_cuda, name):
    widths = TABLES[name]
    code = decode_cuda.stage_code(widths, "cpu")
    meta = decode_cuda.canonical_meta(widths)
    assert code.symbols.dtype == torch.uint8
    np.testing.assert_array_equal(code.symbols.numpy(), meta.symbols)
    assert (code.bounds, code.adj) == (meta.bounds, meta.adj)
    np.testing.assert_array_equal(code.entries.numpy().view(np.uint16),
                                  decode_cuda.lookup_entries(meta))
    assert code.entries.dtype == torch.int16
    assert code.entries.data_ptr() % 16 == 0
    # a CUDA-routed decode refuses a code staged on another device than
    # the words, whole or only its lookup table
    prep, args = _staged()
    geo = dict(num_frames=2, bh=prep.bh, bw=prep.bw, delta=True)
    before = dict(decode_cuda.launches), dict(decode_cuda.path_launches)
    with pytest.raises(ValueError, match="on meta, words on cpu"):
        decode_cuda.decode_images(
            *args, decode_cuda.stage_code(widths, "meta"), **geo)
    with pytest.raises(ValueError, match="table is on meta, words on cpu"):
        decode_cuda.decode_blocks(
            *args, dataclasses.replace(code, entries=code.entries.to("meta")),
            num_steps=64, delta=True)
    assert as_cuda == []
    assert (dict(decode_cuda.launches), dict(decode_cuda.path_launches)) \
        == before


def test_cuda_decode_checks_the_table(as_cuda):
    prep, args = _staged()
    geo = dict(num_frames=2, bh=prep.bh, bw=prep.bw, delta=True)
    e = prep.code.entries
    bad = [e.int(), e[:-1], e[1:], torch.cat([e, e])[::2],
           torch.zeros(256, dtype=torch.int16).view(16, 16)]
    for entries in bad:
        with pytest.raises(ValueError, match="table"):
            decode_cuda.decode_images(
                *args, dataclasses.replace(prep.code, entries=entries), **geo)
    with pytest.raises(ValueError, match="11/5 table"):
        decode_cuda.decode_blocks(
            *args, dataclasses.replace(prep.code, entries=e[:1 << 8]),
            num_steps=64, delta=True)
    with pytest.raises(ValueError, match="table is on meta"):
        decode_cuda.decode_blocks(
            *args, dataclasses.replace(prep.code, entries=e.to("meta")),
            num_steps=64, delta=True)
    assert as_cuda == []


def test_cuda_decode_launches_with_the_table_by_path(as_cuda):
    prep, args = _staged()
    wide = _table("all-16")
    before = dict(decode_cuda.path_launches)
    decode_cuda.decode_images(*args, prep.code, num_frames=2, bh=prep.bh,
                              bw=prep.bw, delta=True, emit_end=True)
    decode_cuda.decode_blocks(*args, wide, num_steps=64, delta=False,
                              delta2d=True)
    (n1, a1), (n2, a2) = as_cuda
    nb = prep.offsets.numel()
    e = prep.code.entries
    # words, n_words, offsets, n_blocks, bh, bw, table..., mode, out, end
    assert n1 == "decode_images"
    assert a1[:4] == (prep.words.data_ptr(), prep.words.numel(),
                      prep.offsets.data_ptr(), nb)
    assert a1[4:6] == (prep.bh, prep.bw)
    assert a1[6:10] == (e.data_ptr(), e.numel(), 1, 1)
    assert a1[11] is not None
    # words, n_words, offsets, n_blocks, num_steps, table..., mode, out, end
    assert n2 == "decode_blocks"
    assert a2[4:9] == (64, wide.entries.data_ptr(), wide.entries.numel(), 0,
                       2)
    assert a2[10] is None
    after = dict(decode_cuda.path_launches)
    assert after["decode_images T2 smem"] == \
        before["decode_images T2 smem"] + 1
    assert after["decode_blocks T2 L1"] == before["decode_blocks T2 L1"] + 1
    feed = ("read-ahead" if decode_cuda.b2_reads_ahead(args[0].numel(), nb)
            else "L1 refill")
    assert after[f"decode_blocks {feed}"] == \
        before[f"decode_blocks {feed}"] + 1
    assert sum(after.values()) == sum(before.values()) + 3


@pytest.mark.parametrize("bd, feed", [(16, "read-ahead"), (4, "L1 refill")])
def test_b2_launches_count_under_their_feed(as_cuda, bd, feed):
    cfg = CodecConfig(block_dim=bd)
    _frames, stream = _stream(2, 32, 48, cfg)
    prep = tfs.prepare_shared(stream, 2, 32, 48, cfg, device="cpu")
    nb, key = prep.offsets.numel(), f"decode_blocks {feed}"
    assert decode_cuda.b2_reads_ahead(prep.words.numel(), nb) == (bd == 16)
    before = dict(decode_cuda.path_launches)
    img, img_args = _staged()
    decode_cuda.decode_images(*img_args, img.code, num_frames=2, bh=img.bh,
                              bw=img.bw, delta=True)
    mid = dict(decode_cuda.path_launches)
    assert mid["decode_blocks read-ahead"] == before["decode_blocks read-ahead"]
    assert mid["decode_blocks L1 refill"] == before["decode_blocks L1 refill"]
    assert sum(mid.values()) == sum(before.values()) + 1
    decode_cuda.decode_blocks(prep.words, prep.offsets, prep.code,
                              num_steps=bd * bd, delta=True)
    after = dict(decode_cuda.path_launches)
    assert after[key] == mid[key] + 1
    assert after["decode_blocks T2 smem"] == mid["decode_blocks T2 smem"] + 1
    assert sum(after.values()) == sum(mid.values()) + 2
    assert [name for name, _args in as_cuda] == ["decode_images",
                                                  "decode_blocks"]
    assert as_cuda[1][1][3:5] == (nb, bd * bd)


def test_b2_feed_follows_the_mean_bytes_a_block():
    at = decode_cuda.AHEAD_MIN_BYTES
    # 4 * n_words // n_blocks + 1 bytes a block, as the kernel's launch: 4
    # blocks of n_words words have n_words + 1
    assert not decode_cuda.b2_reads_ahead(at - 2, 4)
    assert decode_cuda.b2_reads_ahead(at - 1, 4)
    assert decode_cuda.b2_reads_ahead(3 * at, 11)
    assert not decode_cuda.b2_reads_ahead(at, 11)


def test_cpu_decodes_never_reach_the_build(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a CPU tensor reached _build")

    for name in ("launch", "build", "lib"):
        monkeypatch.setattr(_build, name, refuse)
    before = dict(decode_cuda.launches), dict(decode_cuda.path_launches)
    for bd in (4, 8):
        cfg = CodecConfig(block_dim=bd)
        frames, stream = _stream(2, 16, 24, cfg)
        prep = tfs.prepare_shared(stream, 2, 16, 24, cfg, device="cpu",
                                  check=True)
        out, err = tfs.decode_shared_step_checked(prep, cfg)
        np.testing.assert_array_equal(out.numpy(), frames)
        assert not err.any()
        region = tic.ImageCodec(cfg).decode_region(
            tfs.encode_frames_shared(frames[:1], cfg), 16, 24, 2, 3, 9, 13,
            check=True, device="cpu")
        np.testing.assert_array_equal(region, frames[0, 2:11, 3:16])
    assert (dict(decode_cuda.launches), dict(decode_cuda.path_launches)) \
        == before


def test_lookup_table_stages_a_copy():
    widths = native.code_lengths(
        np.bincount(np.arange(40, dtype=np.uint8).repeat(3), minlength=256))
    meta = decode_cuda.canonical_meta(widths)
    table = decode_cuda.stage_code(widths, "cpu")
    table.entries.zero_()  # the cache behind lookup_entries is untouched
    assert (decode_cuda.lookup_entries(meta) != 0).all()
    assert table.num_t2 == 0 and table.t2_in_smem
    assert table.nbytes == 2 << decode_cuda.LUT_K1
